"""Shared helpers for the ``test_torch_*`` parity tests: carry numpy arrays
between the JAX reference package and the PyTorch port."""

import numpy as np
import torch

import jax

from repro.models.common import _path_str

# The suite runs in several worker processes on one host.  One intra-op
# thread per worker keeps the port's many small CPU ops (the HBD step loop,
# per-token decode) from spinning on oversubscribed thread pools, where a
# one-second serve test took minutes.
torch.set_num_threads(1)


def f32_cfg(cfg):
    """Reduced config in float32 (parity tests run f32, TF32 off)."""
    return cfg.reduced(dtype="float32")


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def flat_numpy(params) -> dict:
    """JAX params tree → {dot path: np.ndarray}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {_path_str(p): np.asarray(leaf, np.float32) for p, leaf in flat}


def flat_payload(payload) -> dict:
    """JAX compressor payload → ``repro_torch.convert.payload_from_numpy``
    input."""
    from repro.core.compression import CompressedParam

    def is_cp(x):
        return isinstance(x, CompressedParam)

    flat, _ = jax.tree_util.tree_flatten_with_path(payload, is_leaf=is_cp)
    out = {}
    for path, c in flat:
        entry = {"kind": c.kind, "orig_shape": tuple(c.orig_shape),
                 "orig_dtype": np.dtype(c.orig_dtype).name,
                 "eps": 0.0 if c.tt is None else c.tt.eps}
        if c.kind == "tt":
            entry["cores"] = [np.asarray(g, np.float32) for g in c.tt.cores]
        else:
            entry["raw"] = np.asarray(c.raw, np.float32)
        out[_path_str(path)] = entry
    return out


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def assert_close_scaled(got, ref, rel: float, abs_: float = 0.0):
    """max|got − ref| <= rel·max|ref| + abs_."""
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    bound = rel * float(np.max(np.abs(ref))) + abs_
    assert err <= bound, f"max|Δ| {err:.3e} > {bound:.3e}"
