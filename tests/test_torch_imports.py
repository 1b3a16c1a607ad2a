"""Port boundaries: the PyTorch package, ``chip_smoke.py`` and the card's
timing tools import neither JAX nor the JAX package, and the entry points refuse to run on a
host without a GPU unless the caller asks for the CPU."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import engine
from repro_torch.launch import serve as serve_mod
from repro_torch.models.registry import build

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|"
    r"from\s+repro(\.|\s)(?!_))", re.M)


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    # chip_smoke.py and the card's timing tools (it imports cuda_timing)
    tools = [REPO / "tools" / f"{name}.py"
             for name in ("cuda_timing", "kernel_time", "compress_time",
                          "decode_time", "flash_f32_drift")]
    return files + [REPO / "chip_smoke.py"] + tools


def test_port_files_exist():
    names = {p.name for p in _port_files()}
    assert {"chip_smoke.py", "ops.py", "serve.py", "hbd.py", "blocked.py",
            "plan.py", "batch_exec.py", "resnet32.py",
            "engine_cases.py", "rglru.py", "steps.py",
            "recurrentgemma_2b.py", "olmoe_1b_7b.py", "mlp.py",
            "checkpoint.py", "qwen3_8b.py", "qwen3_32b.py",
            "dbrx_132b.py", "flash_f32_drift.py", "prng.py", "router.py",
            "server.py", "fault_tolerance.py", "encdec.py",
            "seamless_m4t_large_v2.py"} <= names
    assert (REPO / "src" / "repro_torch" / "checkpoint" / "checkpoint.py"
            ).is_file()
    kernels = REPO / "src" / "repro_torch" / "kernels"
    for name in ("tt_contract", "householder", "block_update",
                 "singular_sort", "frob_truncate", "flash_attention"):
        assert (kernels / name / "csrc" / f"{name}.cu").is_file(), name
        assert {"ops.py", "ref.py"} <= {p.name for p in (kernels / name
                                                         ).glob("*.py")}


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: imports JAX or the JAX package"


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jax import lax", True), ("import repro", True),
    ("from repro.core import tt", True), ("from repro import x", True),
    ("import repro_torch", False), ("from repro_torch.core import tt", False),
    ("import jaxlib_free_name", False),
])
def test_forbidden_pattern(line, bad):
    assert bool(FORBIDDEN.search(line)) == bad


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_without_gpu_raises(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_without_device_raise(no_gpu):
    cfg = get_config("qwen1.5-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.serve(serve_mod.parse_args(
            ["--arch", "qwen1.5-0.5b", "--reduced", "--weights", "tt"]))
    model = build(cfg, device="cpu")
    out = engine.generate(model, model.init(0), np.zeros((1, 2), np.int32), 2)
    assert out["gen"].shape == (1, 2)


def test_unported_arch_and_family_raise():
    with pytest.raises(ValueError, match="not ported"):
        get_config("pixtral-12b")
