"""The port stands alone: it imports no JAX and nothing of the JAX
package, runs its CLI on the CPU when asked, and refuses CUDA where there
is none rather than running on the CPU."""

import json
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

import distributed_llm_code_samples_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(port.__file__))
IMPORT_RE = re.compile(
    r"^\s*(?:from|import)\s+(jax|distributed_llm_code_samples_tpu)\b",
    re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="distributed_llm_code_samples_tpu_torch."))


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "distributed_llm_code_samples_tpu_torch.decode.engine" in mods
    code = ("import sys; sys.modules['jax'] = None; "
            "import importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "import chip_smoke; "
            "assert not any(k == 'distributed_llm_code_samples_tpu' or "
            "k.startswith(('distributed_llm_code_samples_tpu.', 'jax.')) "
            "for k in sys.modules); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        with open(path) as f:
            hits = IMPORT_RE.findall(f.read())
        assert not hits, f"{path} imports {hits}"


def test_cuda_is_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        port.resolve_device("cuda")
    assert port.resolve_device("cpu").type == "cpu"
    out = subprocess.run(
        [sys.executable, "-m",
         "distributed_llm_code_samples_tpu_torch.decode.generate_cli",
         "--prompt_lens", "4"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2 and "CUDA" in out.stderr
    assert out.stdout == ""


def test_generate_cli_on_cpu_prints_the_payload():
    out = subprocess.run(
        [sys.executable, "-m",
         "distributed_llm_code_samples_tpu_torch.decode.generate_cli",
         "--device", "cpu", "-d", "32", "-l", "2", "--heads", "4",
         "--kv_heads", "2", "--vocab", "64", "--max_seq_len", "64",
         "--prompt_lens", "5,9,13", "--max_new", "4", "--max_slots", "2",
         "--block_size", "8", "--prefill_chunk", "8", "--kv_dtype",
         "int8", "--use_rope"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    for key in ("sequences", "tokens_generated", "wall_s", "tokens_per_sec",
                "engine_steps", "mean_occupancy", "kv_dtype", "kernel",
                "kernel_launches"):
        assert key in payload
    assert payload["kernel"] == "fused" and payload["kv_dtype"] == "int8"
    assert payload["tokens_generated"] == 12
    assert [len(s["tokens"]) for s in payload["sequences"]] == [9, 13, 17]
    assert payload["kernel_launches"] == {}        # CPU: the plain version
    assert payload["failed"] == {}


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it (or without a card) the smoke script
    exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
