"""The readings that a cell's limits are set from: the program over many seeds, and its control.

    python3 portbench/control.py --workload <name> --seeds 1 2 ... [--control fp8|tf32|int8|program_tf32 ...]
        [--control-seeds 1 2 3] [--calls 1] [--faults half_batch token_altered ...]

In one process, for each seed: the cell's set-up (weights, clips, the
program), ``--calls`` calls of the program through the entry's own call,
each judged as a run judges it (the lower readings); then, on the
``--control-seeds``, the control in the program's place, judged the same
way (the upper readings). One JSON line a reading. The benchmark's own runs
never run this.

Controls: ``fp8`` is the reference with every conv and matmul operand
rounded to float8 e4m3 (per-tensor scale); ``tf32``
rounds them to TF32's 10-bit mantissa, as TF32 tensor cores take them,
accumulating in f32; ``int8`` is the program's own W8A8 path
(``int8_min_channels=128``, HiFi-Codec only), calibrated on the first batch;
``program_tf32`` the program itself (f32) with TF32 on in cuDNN and cuBLAS.
"""

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.faults import DECODED, FAULTS  # noqa: E402


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round an f32 tensor to TF32's 10-bit mantissa (to nearest)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


CASTS = {"fp8": fp8, "tf32": tf32}
PROGRAM_PATHS = ("int8", "program_tf32")


def control_outputs(ctx, i: int, control: str):
    if control in CASTS:
        return ctx.entry.control_outputs(ctx, i, cast=CASTS[control])
    if control == "int8":
        from academicodec_tpu_torch.models.hificodec import calibrate_quant

        fam, cfg = ctx.family, ctx.config
        weights = {k: v.to(ctx.device) for k, v in ctx.state["weights"].items()}
        model = fam.build_program(cfg, weights, torch.bfloat16 if ctx.traffic["dtype"] == "bfloat16"
                                  else torch.float32, ctx.device, int8_min_channels=128)
        calibrate_quant(model, ctx.state["batches"][0][0].to(ctx.device))
        ctx.state["program"] = model
        out = ctx.entry.call(ctx, i)
        ctx.entry.release(ctx)
        return out
    if control == "program_tf32":  # the program as it is, with TF32 on in cuDNN and cuBLAS
        fam, cfg = ctx.family, ctx.config
        weights = {k: v.to(ctx.device) for k, v in ctx.state["weights"].items()}
        ctx.state["program"] = fam.build_program(cfg, weights, torch.float32, ctx.device)
        with ctx.entry.tf32(True):
            out = ctx.entry.call(ctx, i)
        ctx.entry.release(ctx)
        return out
    raise ValueError(f"unknown control {control!r}")


def readings(workload: str, seeds, controls, control_seeds, calls: int, device: str, overrides=None,
             faults=()):
    """Yield one dict a reading: the program's on ``seeds``, each control's on
    ``control_seeds``, and on ``seeds`` the program's first call with each of
    ``faults`` (``portbench/faults.py``) planted in its outputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx = harness.make_context(workload, seed, device, overrides=overrides)
        with torch.no_grad():
            ctx.entry.prepare(ctx)
            outs = [(i, ctx.entry.call(ctx, i)) for i in range(calls)] if seed in seeds else []
            ctx.entry.release(ctx)
            ref = ctx.entry.reference(ctx)
            for i, out in outs:
                yield {"seed": seed, "call": i, "side": "program", **ctx.entry.judge(ctx, i, out, ref)}
            for name in faults if outs else ():
                if outs[0][1][1] is not None or name not in DECODED:
                    out = FAULTS[name](ctx, outs[0][1])
                    yield {"seed": seed, "call": 0, "side": f"fault:{name}", **ctx.entry.judge(ctx, 0, out, ref)}
            for control in controls if seed in control_seeds else ():
                out = control_outputs(ctx, 0, control)
                yield {"seed": seed, "call": 0, "side": f"control:{control}", **ctx.entry.judge(ctx, 0, out, ref)}
        del ctx, ref
        if device == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Readings of the program and of its control for a cell's limits.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", nargs="+", default=["fp8"], choices=sorted(CASTS) + list(PROGRAM_PATHS))
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--calls", type=int, default=1)
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for r in readings(args.workload, args.seeds, args.control, args.control_seeds, args.calls, args.device,
                      faults=args.faults):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
