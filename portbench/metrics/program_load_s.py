"""Host seconds of the run inside the program's ``codec.load`` (``load_codec``:
building the model, reading a checkpoint) and ``kernels.load`` (loading the kernel
library) spans, from the program's registry of span totals, less the seconds of
``kernels.builds``: an ``nvcc`` build inside ``kernels.load``, which only a
checkout's first run makes and which ``first_setup_s`` already shows."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        from academicodec_tpu_torch.utils.profiling import totals
    except ImportError:  # a program without a registry
        return None
    t = totals()
    got = [t[name].seconds for name in ("codec.load", "kernels.load") if name in t and t[name].count]
    if not got:
        return None
    build = t["kernels.builds"].seconds if "kernels.builds" in t else 0.0
    return sum(got) - build
