"""How far a reduced one-head xLSTM's f32 gradients lie from the same step
in f64: the port's and the reference's, each against the port run in f64,
and the two f32 sides against each other.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/xlstm_f64_gap.py [D ...]

For each width D (default 32 and 64): ``xlstm_1p3b`` reduced to 8 layers
and one head, the reference's weights from ``PRNGKey(0)``, a (4, 16) batch
of seeded tokens, ``loss_fn(remat=True)``'s gradient.  The port's f64 run
turns every f32 cast and factory of the port into f64 for its duration (the
port casts its gates and states to f32 itself).  Prints, a leaf name (the
worst over the layers), |port32 - port64| and |ref32 - port64| over
max|port64|, and |port32 - ref32| over max|ref32|: the measure of
``tests/test_torch_mesh.py``'s train cases.  Not a test: it shows where the
f32 reference stops being a 1e-4 oracle for these cases.
"""

from __future__ import annotations

import contextlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import repro.configs as JC  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import from_jax_params, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

import torch_ranks  # noqa: E402

FACTORIES = ("zeros", "ones", "full", "empty", "tensor", "arange", "zeros_like", "ones_like",
             "full_like")


def flat(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flat(v, f"{path}/{i}").items()}
    return {path: np.asarray(tree)}


@contextlib.contextmanager
def f64():
    """``Tensor.float``, ``Tensor.to(torch.float32)`` and the factories'
    ``dtype=torch.float32`` give f64 inside the block."""
    T, saved = torch.Tensor, {n: getattr(torch, n) for n in FACTORIES}
    old_float, old_to = T.float, T.to

    def to(self, *a, **k):
        a = tuple(torch.float64 if x is torch.float32 else x for x in a)
        if k.get("dtype") is torch.float32:
            k["dtype"] = torch.float64
        return old_to(self, *a, **k)

    def factory(f):
        def call(*a, **k):
            if k.get("dtype") is torch.float32:
                k["dtype"] = torch.float64
            return f(*a, **k)
        return call

    T.float, T.to = (lambda self: self.double()), to
    for n, f in saved.items():
        setattr(torch, n, factory(f))
    try:
        yield
    finally:
        T.float, T.to = old_float, old_to
        for n, f in saved.items():
            setattr(torch, n, f)


def port_grads(jp, cfg, tokens, double: bool) -> dict:
    with f64() if double else contextlib.nullcontext():
        p = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        leaves = [(t.double() if double else t).requires_grad_(True)
                  for t in adamw.tree_leaves(p)]
        p = adamw.tree_unflatten(p, leaves)
        loss, _ = transformer.loss_fn(p, cfg, {"tokens": torch.from_numpy(tokens)}, remat=True)
        assert loss.dtype == (torch.float64 if double else torch.float32)
        g = torch.autograd.grad(loss, leaves)
        return flat(adamw.tree_unflatten(p, [x.double().numpy() for x in g]))


def main(widths: list[int]) -> None:
    for d in widths:
        case = ("xlstm_1p3b", dict(n_layers=8, d_model=d, n_heads=1), None)
        jcfg, tcfg = torch_ranks.mesh_cfg(JC, case), torch_ranks.mesh_cfg(TC, case)
        jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
        tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
        _, jg = jax.value_and_grad(lambda p: JT.loss_fn(
            p, jcfg, {"tokens": jnp.asarray(tokens)}, remat=True)[0])(jp)
        ref = flat(jax.tree.map(np.asarray, jg))
        p32, p64 = port_grads(jp, tcfg, tokens, False), port_grads(jp, tcfg, tokens, True)
        period = len(tcfg.block_pattern)
        worst: dict = {}
        for key, g64 in p64.items():
            parts = key.split("/")[1:]
            if parts[0] == "blocks":   # the port's layer l: the reference's group l // period
                l = int(parts[1])
                r = ref["/".join(["", "blocks", str(l % period)] + parts[2:])][l // period]
            else:
                r = ref[key]
            s64 = max(np.abs(g64).max(), 1e-30)
            gaps = (np.abs(p32[key] - g64).max() / s64, np.abs(r - g64).max() / s64,
                    np.abs(p32[key] - r).max() / max(np.abs(r).max(), 1e-30))
            worst[parts[-1]] = np.maximum(worst.get(parts[-1], 0.0), gaps)
        print(f"d {d}: leaf, |port32 - port64| and |ref32 - port64| (x max|port64|), "
              f"|port32 - ref32| (x max|ref32|)")
        for leaf, (a, b, c) in sorted(worst.items(), key=lambda kv: -kv[1][2]):
            print(f"  {leaf:10s} {a:.3e} {b:.3e} {c:.3e}")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [32, 64])
