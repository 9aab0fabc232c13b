"""HiFi-Codec training CLI of the port (the JAX CLI's flags plus ``--device``).

    python -m academicodec_tpu_torch.cli.train_hificodec \\
        --config recipes/HiFi-Codec-24k-320d/config_24k_320d.json \\
        --input_training_file train.lst --input_validation_file valid.lst \\
        --checkpoint_path ckpts/hificodec_24k --device cuda

The config is the reference JSON (unknown keys ignored); it is copied to
``config.json`` beside the checkpoints. The learning rate decays by
``lr_decay`` each epoch. States are ``state_<step>.pt`` under
``--checkpoint_path`` (``utils/checkpoint.py``, the newest
``--num_ckpt_keep`` kept, the epoch in their metadata); a run resumes from
the newest one there. Each holds the generator as a reference ``g_*`` dict,
so ``cli/extract_tokens.py --model_path`` and ``api.load_codec`` serve it.
Validation (the mel error of every validation batch) runs every
``--validation_interval`` steps. ``--fine_tuning --input_mels_dir`` trains
on mel-aligned crops (``data/dataset.MelNpyCropDataset``).

``--native_loader`` reads the training crops with the C++ loader
(``data/native_loader.py``): the same batches as the Python pipeline, bit for
bit; it raises if its library cannot be built. ``--fine_tuning`` keeps the
Python pipeline, which alone yields the paired mels.

``--multihost`` trains data-parallel, one process per card, as ``torchrun``
starts them (``parallel.init_from_env``; NCCL on the cards, gloo with
``--device cpu``):

    torchrun --nproc_per_node 8 -m academicodec_tpu_torch.cli.train_hificodec --multihost \\
        --config config_24k_320d.json --input_training_file train.lst --input_validation_file valid.lst

The batch size stays the global batch (JAX cli/train_hificodec.py:96-102):
each rank loads its shard of every epoch and of the validation set and steps
on ``batch_size / N`` rows; the step is the global batch's
(``train/hificodec.py``). ``--device`` names the local card (``cuda`` is
``cuda:LOCAL_RANK``). Rank 0 writes the log, the config copy and the
states; every rank prints its losses (global-batch means, the same on every
rank) and resumes from the same file.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from academicodec_tpu_torch.data.dataset import MelNpyCropDataset, WavCropDataset, batch_iterator
from academicodec_tpu_torch.data.native_loader import native_batch_iterator
from academicodec_tpu_torch.nn.hifigan import HiFiCodecConfig
from academicodec_tpu_torch.parallel.mesh import init_from_env, missing_torchrun_env, rank, replicate, world_size
from academicodec_tpu_torch.train.hificodec import HiFiCodecTrainConfig, HiFiCodecTrainer
from academicodec_tpu_torch.utils.checkpoint import load_checkpoint, load_checkpoint_meta, save_checkpoint, scan_checkpoint
from academicodec_tpu_torch.utils.logging import Logger, is_primary


def get_args(argv=None):
    p = argparse.ArgumentParser("train_hificodec")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--input_training_file", type=str, required=True)
    p.add_argument("--input_validation_file", type=str, required=True)
    p.add_argument("--checkpoint_path", type=str, default="checkpoints")
    p.add_argument("--training_epochs", type=int, default=2000)
    p.add_argument("--stdout_interval", type=int, default=5)
    p.add_argument("--checkpoint_interval", type=int, default=5000)
    p.add_argument("--validation_interval", type=int, default=5000)
    p.add_argument("--num_ckpt_keep", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=None, help="override config")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: sequential microbatches per optimizer update "
                        "(batch_size %% accum_steps == 0); equal to the monolithic step for this family")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 forwards/backwards with f32 master weights, optimizer state, spectral-norm u "
                        "and loss reductions")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel training over the processes torchrun starts, one per card")
    p.add_argument("--native_loader", action="store_true",
                   help="read training crops with the C++ loader (bit-identical batches)")
    p.add_argument("--fine_tuning", action="store_true",
                   help="mel-aligned crops from precomputed mel .npy files (reference meldataset.py:183-206)")
    p.add_argument("--input_mels_dir", type=str, default=None, help="dir of <stem>.npy mels for --fine_tuning")
    p.add_argument("--device", type=str, default="cuda", help="torch device; the card unless cpu is asked for")
    args = p.parse_args(argv)
    if args.multihost and missing_torchrun_env():
        p.error(f"--multihost needs the torchrun environment ({', '.join(missing_torchrun_env())} unset): "
                "torchrun --nproc_per_node N -m academicodec_tpu_torch.cli.train_hificodec --multihost ...")
    if args.fine_tuning and not args.input_mels_dir:
        p.error("--fine_tuning requires --input_mels_dir")
    return args


def main(argv=None):
    args = get_args(argv)
    with open(args.config) as fh:
        raw = json.load(fh)
    model_cfg = HiFiCodecConfig.from_json(raw)
    cfg = HiFiCodecTrainConfig(
        model=model_cfg, learning_rate=raw.get("learning_rate", 2e-4), adam_b1=raw.get("adam_b1", 0.5),
        adam_b2=raw.get("adam_b2", 0.9), lr_decay=raw.get("lr_decay", 0.98), accum_steps=args.accum_steps,
        mixed_precision=args.mixed_precision,
    )
    batch_size = args.batch_size or raw.get("batch_size", 16)
    if batch_size % args.accum_steps:
        raise SystemExit(f"batch_size {batch_size} is not divisible by --accum_steps {args.accum_steps}")
    group, device = init_from_env(args.device) if args.multihost else (None, args.device)
    # each rank steps on its share of the global batch (JAX cli/train_hificodec.py:96-102)
    pidx, pcount = rank(group), world_size(group)
    if batch_size % pcount or (batch_size // args.accum_steps) % pcount:
        raise SystemExit(f"batch_size {batch_size} with --accum_steps {args.accum_steps} does not split over "
                         f"{pcount} processes")
    local_bs = batch_size // pcount
    trainer = HiFiCodecTrainer(cfg, device=device, group=group)
    logger = Logger(args.checkpoint_path, args=vars(args))
    device = trainer.device
    logger.log_info(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}; "
                    f"process {pidx} of {pcount}", check_primary=False)
    # the config beside the checkpoints (reference env.py:11-16)
    dst = os.path.join(args.checkpoint_path, "config.json")
    if is_primary() and os.path.abspath(args.config) != os.path.abspath(dst):
        shutil.copyfile(args.config, dst)

    seed = raw.get("seed", 1234)
    segment = model_cfg.segment_size
    if args.fine_tuning:
        if args.native_loader:
            logger.log_info("--native_loader ignored: --fine_tuning needs paired precomputed "
                            "mels, which only the Python pipeline yields")
        train_ds = MelNpyCropDataset(args.input_training_file, segment, hop_size=model_cfg.hop_size,
                                     base_mels_path=args.input_mels_dir, sample_rate=model_cfg.sampling_rate,
                                     seed=seed)
    else:
        train_ds = WavCropDataset(args.input_training_file, segment, sample_rate=model_cfg.sampling_rate, seed=seed)
    valid_ds = WavCropDataset(args.input_validation_file, segment, sample_rate=model_cfg.sampling_rate)

    state = trainer.init_state(seed)
    start_epoch = 0
    latest = scan_checkpoint(args.checkpoint_path, "state")
    if latest:
        state.load_state_dict(load_checkpoint(latest))
        start_epoch = int(load_checkpoint_meta(latest).get(
            "epoch", state.step // max(1, len(train_ds) // batch_size)))
        logger.log_info(f"resumed from {latest} at step {state.step}, epoch {start_epoch}")
    replicate(state.generator, group)
    replicate(state.discriminators, group)

    for epoch in range(start_epoch, args.training_epochs):
        trainer.set_epoch_lr(state, epoch)
        t_epoch = time.time()
        if args.native_loader and not args.fine_tuning:
            it = native_batch_iterator(train_ds.files, segment, local_bs, sample_rate=model_cfg.sampling_rate,
                                       seed=seed, epochs=1, start_epoch=epoch, process_index=pidx,
                                       process_count=pcount)
        else:
            it = batch_iterator(train_ds, local_bs, seed=seed, epochs=1, start_epoch=epoch, process_index=pidx,
                                process_count=pcount)
        for batch in it:
            if isinstance(batch, tuple):  # fine-tuning: (wav, mel); the loss recomputes mels from the wav
                batch, _mel = batch
            t0 = time.time()
            state, metrics = trainer.train_step(state, batch)
            step = state.step
            if step % args.stdout_interval == 0:
                logger.log_info(
                    "Steps : {:d}, Gen Loss Total : {:4.3f}, Loss Q : {:4.3f}, Mel-Spec. Error : {:4.3f}, "
                    "s/b : {:4.3f}".format(step, float(metrics["loss_gen_all"]), float(metrics["loss_q"]),
                                           float(metrics["mel_error"]), time.time() - t0), check_primary=False)
            if step % args.checkpoint_interval == 0:
                save_checkpoint(args.checkpoint_path, "state", step, state.state_dict(),
                                num_ckpt_keep=args.num_ckpt_keep, meta={"epoch": epoch})
            if step % args.validation_interval == 0:
                errs = [float(trainer.eval_step(state, vb)["val_mel_error"])
                        for vb in batch_iterator(valid_ds, local_bs, shuffle=False, epochs=1, process_index=pidx,
                                                 process_count=pcount)]
                if errs:
                    logger.log_info(f"validation/mel_spec_error {np.mean(errs):.4f}", check_primary=False)
        logger.log_info(f"Time taken for epoch {epoch + 1} is {int(time.time() - t_epoch)} sec")
    logger.close()
    if group is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
