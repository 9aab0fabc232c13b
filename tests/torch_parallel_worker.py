"""One rank of tests/test_torch_parallel.py's gloo groups, on the CPU.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py <out_prefix>

Joins the group through ``parallel.init_from_env`` (the environment torchrun
gives a rank), runs each helper of ``academicodec_tpu_torch.parallel`` and
the quantizer's data-parallel training forward on this rank's share of
seeded data, and saves what it saw to ``<out_prefix><rank>.pt``.
"""

import sys

import torch
import torch.distributed as dist

from academicodec_tpu_torch import parallel
from academicodec_tpu_torch.quant.core_vq import ResidualVQ, sample_rows

# the quantizer case: a global batch of latents [B, T, D], n_q layers of K entries
VQ_SHAPE = dict(B=4, T=30, D=8, n_q=3, K=16)


def global_latents() -> torch.Tensor:
    s = VQ_SHAPE
    return torch.randn((s["B"], s["T"], s["D"]), generator=torch.Generator().manual_seed(0))


def vq_draws(steps: int = 2) -> list:
    """Each forward's row draws into the global batch's ``B * T`` frames."""
    s, g = VQ_SHAPE, torch.Generator().manual_seed(1)
    return [torch.stack([sample_rows(g, s["B"] * s["T"], s["K"]) for _ in range(s["n_q"])]) for _ in range(steps)]


def vq_run(x: torch.Tensor, group=None) -> dict:
    """A k-means init forward of every layer, then a steady one, on ``x`` (this
    rank's rows under ``group``) -> codes of both and the codebook state."""
    s = VQ_SHAPE
    vq = ResidualVQ(s["n_q"], s["D"], s["K"])
    vq.init_training_state()
    codes = [vq(x, n_q=s["n_q"], training=True, draws=d, group=group)[1] for d in vq_draws()]
    return dict(codes=codes, embed=vq.embed.clone(), embed_avg=vq.embed_avg.clone(),
                cluster_size=vq.cluster_size.clone())


def helpers(group) -> dict:
    r, w = parallel.rank(group), parallel.world_size(group)
    out = dict(rank=r, world=w)
    out["shard"] = parallel.shard_batch(torch.arange(4.0 * w * 3).reshape(4 * w, 3), r, w)
    t, flag, ints = torch.full((3,), r + 1.0), torch.tensor([r == 0, r != 0]), torch.tensor([10 * r + 1])
    parallel.replicate([t, flag, ints], group)
    out["replicated"] = (t, flag, ints)
    summed = torch.full((2, 2), r + 1.0)
    parallel.all_reduce_sum_([summed], group)
    out["summed"] = summed
    lin = torch.nn.Linear(2, 3)
    for i, p in enumerate(lin.parameters()):
        p.grad = torch.full_like(p, float(r + i))
    parallel.all_reduce_mean_grads(lin, group)
    out["grads"] = [p.grad.clone() for p in lin.parameters()]
    out["gathered"] = parallel.all_gather_rows(torch.full((2, 3), float(r)), group)
    x = torch.arange(w * 4 * 5.0).reshape(w * 4, 5)  # a global batch of 4 W rows
    out["micro"] = parallel.microbatches(parallel.shard_batch(x, r, w), 2, group)
    out["metrics"] = parallel.all_reduce_mean_metrics({"a": torch.tensor(float(r)), "b": torch.tensor(2.0 * r)}, group)
    return out


def main(prefix: str) -> None:
    torch.set_num_threads(1)
    group, device = parallel.init_from_env("cpu")
    out = dict(device=str(device), backend=str(dist.get_backend(group)), helpers=helpers(group))
    x = parallel.shard_batch(global_latents(), parallel.rank(group), parallel.world_size(group))
    out["vq"] = vq_run(x, group)
    torch.save(out, f"{prefix}{parallel.rank(group)}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
