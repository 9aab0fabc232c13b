"""Encodec/SoundStream training CLI of the port (the JAX CLI's flags plus ``--device``).

    python -m academicodec_tpu_torch.cli.train_encodec \\
        --train_data_path /data/train --valid_data_path /data/valid \\
        --sr 24000 --ratios 6 5 4 2 --target_bandwidths 1 2 4 8 12 \\
        --batch_size 16 --path ckpts/encodec_24k

``--soundstream`` selects the SoundStream recipe (mel scales 6..10, sim loss
in the feature term, p=0.3 mixtures). Checkpoints are ``latest_<step>.pt``
and ``best_<step>.pt`` under ``--path`` (``utils/checkpoint.py``); ``--resume``
continues from the newest ``latest`` at the epoch its metadata records, and
``cli/compress.py --resume_path`` serves any of them. A tiny run on the CPU:
``--device cpu --n_filters 4 --dimension 32 --bins 64 --debug_tiny_discs``.

``--native_loader`` reads the training crops with the C++ loader
(``data/native_loader.py``): the same batches as the Python pipeline, bit for
bit; it raises if its library cannot be built. ``--packed_conv`` selects a
TPU lowering in JAX and is accepted as a no-op. ``--profile_dir`` records
steps 10-20 of the first epoch with torch.profiler.

``--multihost`` trains data-parallel, one process per card, as ``torchrun``
starts them (``parallel.init_from_env``; NCCL on the cards, gloo with
``--device cpu``):

    torchrun --nproc_per_node 8 -m academicodec_tpu_torch.cli.train_encodec --multihost \\
        --train_data_path /data/train --valid_data_path /data/valid --batch_size 128 ...

``--batch_size`` stays the global batch (JAX cli/train_encodec.py:133-139):
each rank loads its shard of every epoch (``process_index``/``process_count``
of the loaders) and steps on ``batch_size / N`` rows, and the step is the
global batch's (``train/encodec.py``). ``--device`` names the local card
(``cuda`` is ``cuda:LOCAL_RANK``). Rank 0 writes the log and the
checkpoints; every rank prints its losses, which are global-batch means and
so the same on every rank, and every rank resumes from the same file.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from academicodec_tpu_torch.data.dataset import WavCropDataset, batch_iterator
from academicodec_tpu_torch.data.native_loader import native_batch_iterator
from academicodec_tpu_torch.parallel.mesh import init_from_env, missing_torchrun_env, rank, replicate, world_size
from academicodec_tpu_torch.train.encodec import EncodecTrainConfig, EncodecTrainer
from academicodec_tpu_torch.utils.checkpoint import load_checkpoint, load_checkpoint_meta, save_checkpoint, scan_checkpoint
from academicodec_tpu_torch.utils.logging import Logger
from academicodec_tpu_torch.utils.profiling import StepTimer, param_count, trace


def get_args(argv=None):
    p = argparse.ArgumentParser("train_encodec")
    p.add_argument("--seed", type=int, default=6666)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--ratios", type=int, nargs="+", default=[8, 5, 4, 2])
    p.add_argument("--target_bandwidths", type=float, nargs="+", default=[1, 1.5, 2, 4, 6, 12])
    p.add_argument("--train_data_path", type=str, required=True)
    p.add_argument("--valid_data_path", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=80, help="batch size")
    p.add_argument("--n_epochs", type=int, default=300)
    p.add_argument("--segment_seconds", type=float, default=1.0)
    p.add_argument("--lambda_wav", type=float, default=100.0)
    p.add_argument("--lambda_adv", type=float, default=1.0)
    p.add_argument("--lambda_feat", type=float, default=1.0)
    p.add_argument("--lambda_rec", type=float, default=1.0)
    p.add_argument("--lambda_com", type=float, default=1000.0)
    p.add_argument("--discriminator_iter_start", type=int, default=500)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--n_filters", type=int, default=32)
    p.add_argument("--dimension", type=int, default=512)
    p.add_argument("--bins", type=int, default=1024)
    p.add_argument("--debug_tiny_discs", action="store_true", help="shrink discriminators for smoke tests")
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--checkpoint_interval", type=int, default=5000)
    p.add_argument("--path", type=str, default="model_path")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--soundstream", action="store_true", help="SoundStream recipe flavor")
    p.add_argument("--packed_conv", action="store_true",
                   help="the JAX CLI's lanes-packed TPU lowering; the port accepts it and runs its one path")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: sequential microbatches per optimizer update "
                        "(batch_size %% accum_steps == 0)")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 forwards/backwards with f32 master weights, optimizer state, "
                        "EMA codebooks and loss reductions")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel training over the processes torchrun starts, one per card")
    p.add_argument("--native_loader", action="store_true",
                   help="read training crops with the C++ loader (bit-identical batches)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 10-20 here")
    p.add_argument("--device", type=str, default="cuda", help="torch device; the card unless cpu is asked for")
    args = p.parse_args(argv)
    if args.multihost and missing_torchrun_env():
        p.error(f"--multihost needs the torchrun environment ({', '.join(missing_torchrun_env())} unset): "
                "torchrun --nproc_per_node N -m academicodec_tpu_torch.cli.train_encodec --multihost ...")
    if args.batch_size % args.accum_steps:
        p.error(f"--batch_size {args.batch_size} is not divisible by --accum_steps {args.accum_steps}")
    return args


def make_config(args) -> EncodecTrainConfig:
    flavor = dict(
        mel_scale_powers=tuple(range(6, 11)) if args.soundstream else tuple(range(6, 12)),
        feat_include_sim=bool(args.soundstream),
    )
    if args.debug_tiny_discs:
        flavor.update(stft_filters=8, stft_n_ffts=(256,), mpd_periods=(2, 3), msd_scales=1, mel_scale_powers=(6, 7))
    return EncodecTrainConfig(
        sr=args.sr, ratios=tuple(args.ratios), target_bandwidths=tuple(args.target_bandwidths),
        n_filters=args.n_filters, dimension=args.dimension, bins=args.bins,
        lambda_wav=args.lambda_wav, lambda_adv=args.lambda_adv, lambda_feat=args.lambda_feat,
        lambda_rec=args.lambda_rec, lambda_com=args.lambda_com,
        discriminator_iter_start=args.discriminator_iter_start, packed_conv=args.packed_conv,
        accum_steps=args.accum_steps, mixed_precision=args.mixed_precision, lr=args.lr, **flavor,
    )


def main(argv=None):
    args = get_args(argv)
    group, device = init_from_env(args.device) if args.multihost else (None, args.device)
    # each rank steps on its share of the global batch (JAX cli/train_encodec.py:133-139)
    pidx, pcount = rank(group), world_size(group)
    if args.batch_size % pcount or (args.batch_size // args.accum_steps) % pcount:
        raise SystemExit(f"--batch_size {args.batch_size} with --accum_steps {args.accum_steps} does not split "
                         f"over {pcount} processes")
    local_bs = args.batch_size // pcount
    trainer = EncodecTrainer(make_config(args), device=device, group=group)
    logger = Logger(args.path, tensorboard=args.tensorboard, args=vars(args))
    device = trainer.device
    logger.log_info(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}; "
                    f"process {pidx} of {pcount}", check_primary=False)

    segment = int(args.segment_seconds * args.sr)
    train_ds = WavCropDataset(args.train_data_path, segment, sample_rate=args.sr,
                              mixture_prob=0.3 if args.soundstream else 0.0, seed=args.seed)
    valid_ds = WavCropDataset(args.valid_data_path, segment, sample_rate=args.sr)

    state = trainer.init_state(args.seed)
    start_epoch = 0
    if args.resume:
        latest = scan_checkpoint(args.path, "latest")
        if latest:
            state.load_state_dict(load_checkpoint(latest))
            meta = load_checkpoint_meta(latest)
            start_epoch = int(meta.get("epoch", state.step // max(1, len(train_ds) // args.batch_size)))
            logger.log_info(f"resumed from {latest} at step {state.step}, epoch {start_epoch}")
    replicate(state.generator, group)
    replicate(state.discriminators, group)
    logger.log_info(f"generator params: {param_count(state.generator):,}; "
                    f"discriminator params: {param_count(state.discriminators):,}")

    best_valid = float("inf")
    timer = StepTimer()
    for epoch in range(start_epoch, args.n_epochs + 1):
        trainer.set_epoch_lr(state, epoch)
        t_epoch = time.time()
        # one seed and start_epoch keying: both loaders reproduce this epoch's order
        # on resume, and match each other bit for bit
        if args.native_loader:
            it = native_batch_iterator(train_ds.files, segment, local_bs, sample_rate=args.sr,
                                       mixture_prob=train_ds.mixture_prob, seed=args.seed, epochs=1,
                                       start_epoch=epoch, process_index=pidx, process_count=pcount)
        else:
            it = batch_iterator(train_ds, local_bs, seed=args.seed, epochs=1, start_epoch=epoch,
                                process_index=pidx, process_count=pcount)
        with contextlib.ExitStack() as profiling:
            for i, batch in enumerate(it):
                if args.profile_dir and epoch == start_epoch and i == 10:
                    profiling.enter_context(trace(args.profile_dir))
                state, metrics = trainer.train_step(state, batch)
                if i % args.print_freq == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    sps = timer.tick()
                    rate = f" s/b={sps:.3f}" if sps else ""
                    logger.log_info(f"epoch {epoch} step {state.step} "
                                    + " ".join(f"{k}={v:.4f}" for k, v in m.items()) + rate, check_primary=False)
                    for k, v in m.items():
                        logger.add_scalar(f"train/{k}", v, state.step)
                if args.profile_dir and epoch == start_epoch and i == 20:
                    profiling.close()
                    logger.log_info(f"profile of steps 10-20 written to {args.profile_dir}")
                if state.step % args.checkpoint_interval == 0:
                    save_checkpoint(args.path, "latest", state.step, state.state_dict(), meta={"epoch": epoch})
        # validation sweep (reference main_launch.py:365-429)
        vals = [trainer.eval_step(state, batch)
                for batch in batch_iterator(valid_ds, local_bs, shuffle=False, epochs=1, process_index=pidx,
                                            process_count=pcount)]
        if vals:
            mean = {k: float(np.mean([float(v[k]) for v in vals])) for k in vals[0]}
            logger.log_info(f"epoch {epoch} valid " + " ".join(f"{k}={v:.4f}" for k, v in mean.items()),
                            check_primary=False)
            for k, v in mean.items():
                logger.add_scalar(f"valid/{k}", v, state.step)
            if mean["valid_loss_g"] < best_valid:  # reference main_launch.py:430-443
                best_valid = mean["valid_loss_g"]
                save_checkpoint(args.path, "best", state.step, state.state_dict(), meta={"epoch": epoch + 1})
                logger.log_info(f"new best valid_loss_g={best_valid:.4f}")
        # resume continues at the next epoch
        save_checkpoint(args.path, "latest", state.step, state.state_dict(), meta={"epoch": epoch + 1})
        logger.log_info(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
    logger.close()
    if group is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
