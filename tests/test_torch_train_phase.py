"""chip_smoke's training phase and its launch counts, at a tiny width on the CPU.

``chip_smoke.train_launches`` (the K1/K2 launches the card must show in a
training step) is held against the trainer's own calls of the kernels'
wrappers, and ``chip_smoke.phase_train`` is rehearsed end to end.
"""

import torch

from tests.test_torch_train import TINY, one_torch_thread, seeded_batch  # noqa: F401 (an autouse fixture)
from academicodec_tpu_torch.train.encodec import EncodecTrainConfig, EncodecTrainer


def test_train_launch_prediction_counts_the_calls(monkeypatch):
    """``chip_smoke.train_launches`` against the trainer's own calls of K1's
    and K2's wrappers, counted on the CPU (where they run the plain versions):
    the init step with every layer drawn, then a drawn step, monolithic and
    with ``accum_steps=2``."""
    import chip_smoke
    from academicodec_tpu_torch.nn import lstm as nn_lstm
    from academicodec_tpu_torch.quant import core_vq
    from academicodec_tpu_torch.train.encodec import ForwardDraws, StepDraws

    calls = {"rvq_encode": 0, "lstm2": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(core_vq, "rvq_encode", counted("rvq_encode", core_vq.rvq_encode))
    monkeypatch.setattr(nn_lstm, "lstm2", counted("lstm2", nn_lstm.lstm2))
    for accum in (1, 2):
        trainer = EncodecTrainer(EncodecTrainConfig(**TINY, accum_steps=accum), device="cpu")
        state = trainer.init_state(0)
        x = seeded_batch()
        n_q = state.generator.quantizer.vq.num_quantizers
        drawn = trainer.draw(state, x.shape)
        for step, draws in enumerate((StepDraws(ForwardDraws(n_q, drawn.g.rows), ForwardDraws(n_q, drawn.d.rows)),
                                      None)):
            calls.update(rvq_encode=0, lstm2=0)
            state, _ = trainer.train_step(state, x, draws=draws)
            init_layers = n_q if step == 0 else 0
            expected = chip_smoke.train_launches(state.generator, init_layers, accum)
            if step == 0 and accum == 2:  # microbatch 1 finds every layer inited
                expected["rvq_encode"] -= n_q * (core_vq.KMEANS_ITERS + 2) - 1
            assert calls == expected, (accum, step, calls, expected)


def test_chip_smoke_phase_train_rehearsal():
    """chip_smoke's ``train`` phase at a tiny width on the CPU: the f32 and
    mixed-precision runs, the card-vs-CPU step (here CPU against CPU) and the
    CLI's two epochs, resume and compress."""
    import chip_smoke

    r = chip_smoke.phase_train("cpu", batch=2, seconds=0.2, steps=1, mp_steps=1, recipe=TINY, cross=TINY,
                               cross_batch=2, cross_seconds=0.2, cli_width=TINY, cli_files=4, cli_batch=2,
                               cli_segment_seconds=0.2)
    assert r["f32"]["inited"] and r["mixed_precision"]["inited"]
    assert r["cross"]["codes_equal"] and r["cross"]["grad_max_rel_diff"] == 0.0
    assert r["cli"]["steps_after_two_epochs"] == 4 and r["cli"]["steps_after_resume"] == 6


def test_near_ties_reports_the_first_parting_layer_with_the_cpu_margin():
    """``chip_smoke._near_ties`` on a hand-made search: two frames, two layers,
    codes parting at layer 1 of batch row 1 (item 5): it reports that item,
    frame and layer once, with the CPU's margin (second nearest - nearest) /
    nearest computed on the residual the CPU's layer 0 left."""
    import chip_smoke

    latents = torch.tensor([[[0.0, 0.0]], [[1.0, 0.0]]])  # [B 2, T 1, D 2]
    embed = torch.tensor([[[0.0, 0.0], [1.0, 0.0]], [[0.1, 0.0], [-0.2, 0.0]]])  # [n_q 2, K 2, D 2]
    cpu = torch.tensor([[[0], [1]], [[0], [0]]])  # [n_q, B, T]
    card = cpu.clone()
    card[1, 1, 0] = 1
    ties = chip_smoke._near_ties((latents, embed), card, cpu, items=[2, 5])
    assert len(ties) == 1
    item, frame, layer, margin, cond = ties[0]
    # layer 1 sees residual 0: distances 0.01 and 0.04
    assert (item, frame, layer) == (5, 0, 1)
    assert abs(margin - 3.0) < 1e-5 and cond == 0.0
