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
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("decode.engine", "cli", "ops.fused_ffn", "parallel.single",
              "data", "optim", "models.ffn_stack", "ops.flash_attention",
              "ops.fused_xent", "ops.xent", "parallel.lm",
              "parallel.transformer", "ops.ring", "parallel.mesh",
              "parallel.collectives", "parallel.launcher", "parallel.ddp",
              "parallel.fsdp", "ops.moe", "models.moe", "parallel.expert",
              "parallel.tp", "parallel.hybrid", "parallel.zero1",
              "checkpoint", "runtime.chaos", "runtime.failure",
              "runtime.native", "runtime.wire", "train_real_text"):
        assert f"distributed_llm_code_samples_tpu_torch.{m}" in mods
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


TRAIN_CLI = [sys.executable, "-m", "distributed_llm_code_samples_tpu_torch.cli"]
TINY = ["-s", "2", "-bs", "2", "-n", "16", "-l", "2", "-d", "32", "-r", "7"]


def test_train_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(TRAIN_CLI + ["-m", "1"] + TINY, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and "CUDA" in out.stderr
    assert out.stdout == ""


def test_train_cli_on_cpu_prints_the_payload():
    out = subprocess.run(TRAIN_CLI + ["--device", "cpu", "-m", "1", "--pallas"]
                         + TINY, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ARGS:") and "PARAMS: 16_384" in out.stdout
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["kernel_launches"] == {}        # CPU: the plain versions
    assert payload["steps"] == 2 and payload["tokens_per_step"] == 32
    assert payload["pallas"] is True and payload["device"] == "cpu"
    assert len(payload["layer_checksums"]) == 2
    for key in ("wall_s", "median_step_ms", "tokens_per_s",
                "model_tflops_per_s"):
        assert payload[key] > 0


@pytest.mark.parametrize("method", ["6", "9"])
def test_train_cli_refuses_unported_methods(method):
    out = subprocess.run(TRAIN_CLI + ["--device", "cpu", "-m", method]
                         + TINY, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2
    assert f"method {method} is not ported yet" in out.stderr
    assert out.stdout == ""


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


def test_a_spawned_rank_imports_no_jax():
    """A rank of the launcher starts in a fresh interpreter (start method
    ``spawn``): what it imports to run a trainer is the port alone, though
    the process that launched it (this one) has JAX loaded."""
    from distributed_llm_code_samples_tpu_torch.data import (
        make_seed_schedule)
    from distributed_llm_code_samples_tpu_torch.models.ffn_stack import (
        init_ffn_stack)
    from distributed_llm_code_samples_tpu_torch.parallel import (
        DATA_AXIS, launch, make_mesh, train_fsdp)
    from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
        MESH, call_each)
    assert "jax" in sys.modules
    params = init_ffn_stack(torch.Generator().manual_seed(0), 16, 1)
    seeds = make_seed_schedule(2, 7)
    probe = ("sorted(k for k in __import__('sys').modules if k == 'jax' or "
             "k == 'distributed_llm_code_samples_tpu' or k.startswith(("
             "'jax.', 'distributed_llm_code_samples_tpu.')))")
    outs = launch(call_each, make_mesh({DATA_AXIS: 2}, device="cpu"),
                  [(train_fsdp, (params, seeds, 8, 16, MESH),
                    {"comm": "pallas_ring"}), (eval, (probe,), {})],
                  timeout=120)
    assert [o[1] for o in outs] == [[], []]


@pytest.mark.parametrize("module", ["torch_tp_ranks", "torch_dp_ranks",
                                    "torch_bf16_ranks"])
def test_rank_body_modules_import_no_jax(module):
    """The tests' rank bodies, which spawned ranks import by name, load
    the port alone: imported where JAX cannot be, they bring in neither
    JAX nor the JAX package, and the data-parallel trainers they drive
    are there."""
    code = ("import sys; sys.modules['jax'] = None; "
            f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r}); "
            f"import {module}; "
            "from distributed_llm_code_samples_tpu_torch.parallel import ("
            "train_lm_ddp, train_lm_fsdp, train_lm_hybrid, "
            "train_transformer_ddp, train_transformer_fsdp, "
            "train_transformer_hybrid); "
            "assert not any(k == 'distributed_llm_code_samples_tpu' or "
            "k.startswith(('distributed_llm_code_samples_tpu.', 'jax.')) "
            "for k in sys.modules); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
