"""The kill path of the port's CLI, end to end on the CPU, as JAX's
``test_chaos.py::test_kill_fault_recovers_bit_identical_via_cli``.

``cli.py -m 1 --device cpu`` (d 16, 2 layers, 8 steps of 2 x 16 tokens,
lr 0.1, ``-r 3``) with ``--checkpoint_every 2 --chaos kill@4``: the first
run is SIGKILLed right after step 4 is published, the same command run
again resumes past it (the fault keys on that publish, which a resumed run
never repeats) and publishes step 8, whose params equal the uninterrupted
run's (``run_with_checkpointing`` in process, from the CLI's init and
schedule) bit for bit. On the native backend (the async C++ writer; the
npz backend's resume is held in process, ``test_torch_checkpoint_resume``).
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from distributed_llm_code_samples_tpu_torch import checkpoint as ck
from distributed_llm_code_samples_tpu_torch.data import make_seed_schedule
from distributed_llm_code_samples_tpu_torch.models import init_ffn_stack
from distributed_llm_code_samples_tpu_torch.parallel import train_single
from torch_serve_refs import one_thread  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kill_fault_recovers_bit_identical_via_cli(tmp_path):
    ck_dir = str(tmp_path / "ck")
    args = [sys.executable, "-m", "distributed_llm_code_samples_tpu_torch.cli",
            "--device", "cpu", "-s", "8", "-bs", "2", "-n", "16", "-l", "2",
            "-d", "16", "-m", "1", "-r", "3", "--lr", "0.1",
            "--checkpoint_dir", ck_dir, "--checkpoint_every", "2",
            "--checkpoint_backend", "native", "--chaos", "kill@4"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r1 = subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                        env=env, timeout=300)
    assert r1.returncode == -signal.SIGKILL, r1.stdout + r1.stderr
    sub = os.path.join(ck_dir, "train_single")
    assert ck.latest_verified_step(sub) == 4
    r2 = subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                        env=env, timeout=300)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    payload = json.loads(r2.stdout.strip().splitlines()[-1])
    assert payload["latest_verified_step"] == 8 and payload["supervised"]
    with open(os.path.join(sub, "supervise.jsonl")) as f:
        events = [json.loads(ln)["event"] for ln in f]
    # the first attempt's publishes, then the resumed attempt's
    assert events == ["published"] * 2 + ["published"] * 2 + ["completed"]
    gen = torch.Generator()
    gen.manual_seed(3)
    params = init_ffn_stack(gen, 16, 2)
    ref = ck.run_with_checkpointing(train_single, params,
                                    make_seed_schedule(8, 3), 2 * 16, 16,
                                    ckpt_dir=str(tmp_path / "oracle"),
                                    every=2, lr=0.1)
    got, step, _ = ck.restore_checkpoint(sub, params)
    assert step == 8
    for g, w in zip(got, ref):
        assert torch.equal(g, w)
