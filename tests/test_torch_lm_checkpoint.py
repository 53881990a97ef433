"""Train checkpoints of the ``lm`` and ``recsys`` trainers across the two
packages, on the CPU.  A JAX ``launch.train --steps 3`` checkpoint
resumes under the port to step 6 and lands within rtol 1e-4 (atol 1e-6,
the ``STEP`` tolerance of ``tests/test_torch_train.py``) of 6 port steps
run straight through from the same initial state (JAX's, saved as a
step-0 checkpoint that the port's CLI resumes); the other way round, a
port ``--steps 3`` checkpoint resumes under JAX to step 6 and lands as
close to 6 JAX steps from the port's initial state.  ``deepseek-v2-236b``'s
smoke config covers MLA, MoE, the dense prefix list and Adafactor on
stacked leaves; ``mind`` AdamW on its tables.
"""

import numpy as np
import pytest

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.launch import train as jtrain

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.launch import train as ttrain

STEP = dict(rtol=1e-4, atol=1e-6)


def _args(arch, d, steps):
    return ["--arch", arch, "--steps", str(steps), "--ckpt-dir", str(d), "--ckpt-every", "3",
            "--log-every", "3"]


def _params(d, step):
    flat, _ = load_checkpoint(str(d), step)
    return {k: v for k, v in flat.items() if k.startswith("params/")}


def _close(got, want):
    assert set(got) == set(want) and len(want) > 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP, err_msg=k)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mind"])
def test_checkpoints_resume_across_the_packages(arch, tmp_path, capsys):
    # JAX's --steps 3 -> the port to step 6, against the port from JAX's step 0
    _, jstate, _ = jtrain.build_smoke_trainer(arch)
    jax_save(str(tmp_path / "straight_port"), 0, jstate, extra={"data_step": 0})
    assert jtrain.main(_args(arch, tmp_path / "jax3", 3)) == 0
    capsys.readouterr()
    assert ttrain.main(_args(arch, tmp_path / "jax3", 6) + ["--device", "cpu"]) == 0
    assert "[resume] restored step 3" in capsys.readouterr().out
    assert ttrain.main(_args(arch, tmp_path / "straight_port", 6) + ["--device", "cpu"]) == 0
    assert "[resume] restored step 0" in capsys.readouterr().out
    _close(_params(tmp_path / "jax3", 6), _params(tmp_path / "straight_port", 6))

    # the port's --steps 3 -> JAX to step 6, against JAX from the port's step 0
    _, tstate, _ = ttrain.build_smoke_trainer(arch, device="cpu")
    save_checkpoint(str(tmp_path / "straight_jax"), 0, tstate, extra={"data_step": 0})
    assert ttrain.main(_args(arch, tmp_path / "port3", 3) + ["--device", "cpu"]) == 0
    capsys.readouterr()
    assert jtrain.main(_args(arch, tmp_path / "port3", 6)) == 0
    assert "[resume] restored step 3" in capsys.readouterr().out
    assert jtrain.main(_args(arch, tmp_path / "straight_jax", 6)) == 0
    _close(_params(tmp_path / "port3", 6), _params(tmp_path / "straight_jax", 6))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen2-1.5b", "mind"])
def test_train_state_checkpoint_keys_are_jax_keys(arch, tmp_path):
    _, jstate, _ = jtrain.build_smoke_trainer(arch)
    _, tstate, _ = ttrain.build_smoke_trainer(arch, device="cpu")
    jax_save(str(tmp_path / "j"), 1, jstate)
    save_checkpoint(str(tmp_path / "t"), 1, tstate)
    jflat, jman = jax_load(str(tmp_path / "j"), 1)
    tflat, tman = load_checkpoint(str(tmp_path / "t"), 1)
    assert jman["keys"] == tman["keys"] and jman["dtypes"] == tman["dtypes"]
    assert all(jflat[k].shape == tflat[k].shape for k in jflat)
