"""Multi-rank sharding (new vs the reference, which is single-device only).

The port of ``examples/multichip.py``. The JAX script runs one process on
a mesh of (virtual) devices; here the same steps run in ``world``
processes, one per rank, started by `parallel.launch.run` and joined in
one gloo process group (gloo also runs several ranks on one card, which
NCCL refuses):

    python -m tntorch_tpu_torch.examples.multichip                 # 4 ranks on the card, float32
    TN_DEVICE=cpu python -m tntorch_tpu_torch.examples.multichip   # 8 ranks on the CPU, float64

Rank 0 prints; ``main()`` returns rank 0's figures.
"""

import numpy as np
import torch
import torch.distributed as dist

import tntorch_tpu_torch as tn
from tntorch_tpu_torch.examples import figure, resolve
from tntorch_tpu_torch.parallel import (
    gather, launch, make_mesh, round_tt_batch_sharded, round_tt_gram_sharded, shard_array,
    shard_batch, shard_ranks, sharded_dot, sharded_norm, tt_forward_sharded,
)
from tntorch_tpu_torch.utils import seed

# Ranks: the JAX script's 8 virtual devices on the CPU; 4 on the card
WORLD = {"cpu": 8, "cuda": 4}


def _spec(x):
    """The mesh axis that shards each dimension of the DTensor ``x``, or
    None: the JAX package's ``PartitionSpec``."""
    names = x.device_mesh.mesh_dim_names
    spec = [None] * x.ndim
    for name, p in zip(names, x.placements):
        if p.is_shard():
            spec[p.dim] = name
    return spec


def _tutorial(device, dtype):
    """The JAX script's ``main()``, on one rank."""
    say = print if dist.get_rank() == 0 else (lambda *args: None)
    torch.set_default_dtype(dtype)
    kw = dict(device=device, dtype=dtype)
    out = {}
    n = dist.get_world_size()
    say(f"{n} ranks on {device}")
    shape = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    mesh = make_mesh(shape, ("dp", "tp"), device=device)
    out["devices"], out["mesh_shape"] = n, list(shape)
    say("mesh:", mesh)

    # Rank-parallel contraction: TT-rank edges shard over 'tp'
    a = tn.randn(16, 16, 16, 16, ranks_tt=8, generator=seed(0, "cpu"), **kw)
    b = tn.randn(16, 16, 16, 16, ranks_tt=8, generator=seed(1, "cpu"), **kw)
    asr, bsr = shard_ranks(a, mesh), shard_ranks(b, mesh)
    out["dot"], out["norm"] = float(sharded_dot(asr, bsr)), float(sharded_norm(asr))
    out["dot_one_rank"], out["norm_one_rank"] = float(tn.dot(a, b)), float(tn.norm(a))
    say("sharded dot:", out["dot"], " norm:", out["norm"])

    # Data-parallel batch: leading batch dim shards over 'dp'
    tb = tn.randn(8 * shape[0], 8, 8, 8, ranks_tt=4, batch=True, generator=seed(2, "cpu"), **kw)
    tbs = shard_batch(tb, mesh)
    out["batch_spec"] = _spec(tbs.cores[0])
    say("batch-sharded cores:", [c.placements for c in tbs.cores][:1])

    # Sharded forward: samples over dp, rank edges over tp
    X = torch.from_numpy(np.random.default_rng(0).integers(0, 16, (128, 4)))
    yv = tt_forward_sharded(list(a.cores), X, mesh)
    out["forward_shape"], out["forward_spec"] = list(yv.shape), _spec(yv)
    ref = tn.tt_eval(a.cores, X)
    out["forward_err"] = float((gather(yv) - ref).abs().max() / ref.abs().max())
    say("sharded forward:", tuple(yv.shape), yv.placements)

    # Distributed heavy algorithms: multi-rank Gram rounding (cores sharded
    # along their MODE dims, one all-reduce per Gram) ...
    s = a + a  # rank doubles to 16
    rounded = round_tt_gram_sharded(list(s.cores), 8, mesh, axis="tp")
    t_r = tn.Tensor([gather(c) for c in rounded])
    out["round_ranks"] = figure(t_r.ranks_tt)
    out["round_rel_err"] = float(tn.relative_error(a * 2, t_r))
    say("sharded Gram rounding:", out["round_ranks"], " rel-err vs 2a:", out["round_rel_err"])

    # ... batch-sharded rounding (batch dim over dp, no communication) ...
    sb = tbs + tbs
    brounded = round_tt_batch_sharded(list(sb.cores), 4, mesh, axis="dp")
    out["batch_round_local_shapes"] = [list(c.to_local().shape) for c in brounded[:2]]
    say("batch-sharded rounding:", [tuple(c.shape) for c in brounded][:2])

    # ... and dp-sharded training: replicated cores and sharded samples; the
    # gradients' all-reduce comes with optimize(..., mesh=)
    w = tn.rand([16] * 4, ranks_tt=4, requires_grad=True, generator=seed(3, "cpu"), **kw)
    Xs = shard_array(np.random.default_rng(1).integers(0, 16, (64 * shape[0], 4)), mesh)
    ys = shard_array(a.numpy()[tuple(gather(Xs).cpu().numpy().T)], mesh)

    def loss(t):
        pred = tn.parallel.tt_batch_forward(list(t.cores), Xs)
        return torch.mean((pred - ys) ** 2)

    hist = tn.optimize(w, loss, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2),
                       max_iter=50, tol=None, verbose=False, mesh=mesh)
    out["iters"], out["loss_first"], out["loss_last"] = len(hist), hist[0], hist[-1]
    say(f"dp-sharded optimize: loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    return out


def main(device=None, dtype=None) -> dict:
    device, dtype = resolve(device, dtype)
    return launch.run(_tutorial, WORLD[device.type], "gloo", device=device.type,
                      args=(device.type, dtype))[0]


if __name__ == "__main__":
    main()
