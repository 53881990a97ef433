"""The port's checkpoints (``repro_torch.checkpoint``) and update journal
against the JAX package's (``repro.checkpoint``, ``repro.core.dynamic``):
the step-dir layout, the manifest and the LATEST pointer are shared, so an
engine checkpoint written by either package loads in the other, and a
journal replayed onto the restored engine reaches the state of the engine
that never stopped.  Tolerance: exact (``np.array_equal``; bf16 compared as
its uint16 bit view).  Also the JAX suite's journal and engine-checkpoint
tests (``tests/test_executor.py``) on the port.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import load_engine_checkpoint as jax_load_engine_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.checkpoint import save_engine_checkpoint as jax_save_engine_checkpoint
from repro.core import DynamicAPSP as JaxDynamicAPSP
from repro.core.dynamic import UpdateJournal as JaxUpdateJournal
from repro.core.graphgen import generate_np
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    load_engine_checkpoint,
    save_checkpoint,
    save_engine_checkpoint,
)
from repro_torch.core import DynamicAPSP, UpdateJournal, generate_edge_updates
from repro_torch.core.convert import to_numpy


@pytest.fixture(autouse=True)
def _own_autotune_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port-autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax-autotune.json"))


def graph(n=16, seed=0):
    return generate_np(np.random.default_rng(seed), n, rho=60.0).h


def host(a):
    if isinstance(a, torch.Tensor):
        return to_numpy(a)[0]
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def engines(h, with_pred, bf16, **kw):
    jkw, pkw = dict(kw), dict(kw)
    if bf16:
        jkw["dtype"], pkw["dtype"] = jnp.bfloat16, torch.bfloat16
    return (JaxDynamicAPSP(h, with_pred=with_pred, block_size=8, **jkw),
            DynamicAPSP(h, with_pred=with_pred, block_size=8, device="cpu", **pkw))


def updates(n, count, seed, lo=0.5, hi=8.0):
    r = np.random.default_rng(seed)
    u = r.integers(0, n, count)
    v = r.integers(0, n, count)
    v = np.where(v == u, (v + 1) % n, v)
    w = r.uniform(lo, hi, count).astype(np.float32)
    return u.astype(np.int32), v.astype(np.int32), w


# ---------------------------------------------------------------------------
# engine checkpoints across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_engine_checkpoint_loads_across_packages(tmp_path, direction, with_pred, bf16):
    rng = np.random.default_rng(4)
    h = graph(20, 3)
    jeng, peng = engines(h, with_pred, bf16)
    for _ in range(2):
        batch = generate_edge_updates(rng, jeng.h, 4, worsen_frac=0.25)
        jeng.update(*batch)
        peng.update(*batch)
    d = str(tmp_path)
    if direction == "jax_to_port":
        jax_save_engine_checkpoint(d, jeng)
        st = load_engine_checkpoint(d)
        restored = DynamicAPSP(st["h"], with_pred=with_pred, block_size=8, device="cpu",
                               state=st)
        assert restored.dist.dtype == (torch.bfloat16 if bf16 else torch.float32)
    else:
        save_engine_checkpoint(d, peng)
        st = jax_load_engine_checkpoint(d)
        restored = JaxDynamicAPSP(st["h"], with_pred=with_pred, block_size=8, state=st)
        assert str(np.asarray(restored.dist).dtype) == ("bfloat16" if bf16 else "float32")
    assert st["state_dtype"] == ("bfloat16" if bf16 else "float32")
    assert st["with_pred"] is with_pred and st["n"] == 20
    assert restored.version == jeng.version == peng.version
    assert np.array_equal(host(restored.dist), host(jeng.dist))
    assert np.array_equal(host(restored.dist), host(peng.dist))
    assert np.array_equal(restored.h, peng.h)
    if with_pred:
        assert np.array_equal(host(restored.pred), host(peng.pred))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_plus_journal_replay_across_packages(tmp_path, direction, bf16):
    """Checkpoint, keep updating with a journal, then restore in the other
    package from the checkpoint and replay the journal past it: bit-equal
    to the engine that never stopped."""
    rng = np.random.default_rng(8)
    h = graph(24, 5)
    jeng, peng = engines(h, True, bf16)
    ck, wal = str(tmp_path / "ck"), str(tmp_path / "g.wal")
    src = jeng if direction == "jax_to_port" else peng
    journal = (JaxUpdateJournal if direction == "jax_to_port" else UpdateJournal)(wal)
    src.journal = journal
    (jax_save_engine_checkpoint if direction == "jax_to_port" else save_engine_checkpoint)(
        ck, src)
    for _ in range(4):
        src.update(*generate_edge_updates(rng, src.h, 5, worsen_frac=0.2))
    journal.close()
    # the restored engine is built as the original was (its dtype too: a
    # replayed worsening may re-solve from h)
    if direction == "jax_to_port":
        st = load_engine_checkpoint(ck)
        restored = DynamicAPSP(st["h"], with_pred=True, block_size=8, device="cpu", state=st,
                               **({"dtype": torch.bfloat16} if bf16 else {}))
        UpdateJournal(wal).replay_onto(restored, min_version=st["version"])
    else:
        st = jax_load_engine_checkpoint(ck)
        restored = JaxDynamicAPSP(st["h"], with_pred=True, block_size=8, state=st,
                                  **({"dtype": jnp.bfloat16} if bf16 else {}))
        JaxUpdateJournal(wal).replay_onto(restored, min_version=st["version"])
    assert restored.version == src.version
    assert np.array_equal(host(restored.dist), host(src.dist))
    assert np.array_equal(host(restored.pred), host(src.pred))
    assert np.array_equal(restored.h, src.h)


def test_manifest_and_layout_match_jax(tmp_path):
    jeng, peng = engines(graph(12), True, False)
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jax_save_engine_checkpoint(str(jd), jeng)
    save_engine_checkpoint(str(pd), peng)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(pd))
    assert (jd / "LATEST").read_text() == (pd / "LATEST").read_text()
    step = (jd / "LATEST").read_text()
    jm = json.loads((jd / step / "manifest.json").read_text())
    pm = json.loads((pd / step / "manifest.json").read_text())
    assert jm == pm
    jf, _ = jax_load_checkpoint(str(jd))
    pf, _ = load_checkpoint(str(pd))
    assert sorted(jf) == sorted(pf)
    for k in jf:
        assert jf[k].dtype == pf[k].dtype and np.array_equal(jf[k], pf[k])


def test_pytree_checkpoint_keys_match_jax(tmp_path):
    """Nested dict / list leaves are keyed by path with dict keys sorted, as
    ``jax.tree_util`` keys them; either package loads the other's."""
    tree = {"opt": {"mu": np.arange(3, dtype=np.float32), "step": np.int32(7)},
            "layers": [np.ones((2, 2), np.float32), np.zeros(4, np.int32)]}
    port_tree = {"opt": {"mu": torch.arange(3, dtype=torch.float32), "step": np.int32(7)},
                 "layers": [torch.ones(2, 2), torch.zeros(4, dtype=torch.int32)]}
    jax_save_checkpoint(str(tmp_path / "j"), 3, tree, extra={"cursor": 5})
    save_checkpoint(str(tmp_path / "p"), 3, port_tree, extra={"cursor": 5})
    jf, jm = load_checkpoint(str(tmp_path / "j"))
    pf, pm = jax_load_checkpoint(str(tmp_path / "p"))
    assert jm == pm and sorted(jf) == sorted(pf) == ["layers/0", "layers/1", "opt/mu", "opt/step"]
    for k in jf:
        assert np.array_equal(jf[k], pf[k]) and jf[k].dtype == pf[k].dtype
    assert latest_step(str(tmp_path / "p")) == 3


def test_bf16_leaf_is_stored_as_its_bit_view(tmp_path):
    t = torch.tensor([1.5, -2.25, float("inf")], dtype=torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"w": t})
    flat, manifest = load_checkpoint(str(tmp_path))
    assert manifest["dtypes"]["w"] == "bfloat16" and flat["w"].dtype == np.uint16
    assert np.array_equal(flat["w"], t.view(torch.int16).numpy().view(np.uint16))


def test_checkpoint_manager_keeps_the_last_and_surfaces_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(4):
        mgr.save(step, {"x": torch.full((3,), float(step))})
    mgr.wait()
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == [
        "step_000000002", "step_000000003"]
    flat, _ = load_checkpoint(str(tmp_path))
    assert np.array_equal(flat["x"], np.full(3, 3.0, np.float32))
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    bad = CheckpointManager(str(blocked / "sub"))
    with pytest.raises(OSError):
        bad.save(0, {"x": np.zeros(1)})
        bad.wait()


def test_missing_checkpoint_raises(tmp_path):
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        load_engine_checkpoint(str(tmp_path))
    save_checkpoint(str(tmp_path), 0, {"x": np.zeros(1)})
    with pytest.raises(ValueError, match="not an engine checkpoint"):
        load_engine_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# the JAX suite's journal and engine-checkpoint tests (tests/test_executor.py)
# ---------------------------------------------------------------------------

def test_journal_append_records_roundtrip(tmp_path):
    j = UpdateJournal(str(tmp_path / "g.wal"))
    assert len(j) == 0
    j.append([0], [1], [2.0], version_before=0)
    j.append([3, 4], [5, 6], [1.0, 7.0], version_before=1)
    recs = j.records()
    assert [r["seq"] for r in recs] == [0, 1]
    assert [r["v0"] for r in recs] == [0, 1]
    assert recs[1]["u"] == [3, 4] and recs[1]["w"] == [1.0, 7.0]
    assert [r["seq"] for r in j.records(min_version=1)] == [1]
    j.close()
    j2 = UpdateJournal(str(tmp_path / "g.wal"))
    assert j2.append([7], [8], [3.0], version_before=2) == 2
    j2.close()


def test_journal_ignores_torn_tail(tmp_path):
    path = str(tmp_path / "g.wal")
    j = UpdateJournal(path)
    j.append([0], [1], [2.0], version_before=0)
    j.append([2], [3], [4.0], version_before=1)
    j.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"seq": 2, "v0": 2, "u": [5')
    j2 = UpdateJournal(path)
    assert [r["seq"] for r in j2.records()] == [0, 1]
    assert j2.append([5], [6], [1.0], version_before=2) == 2
    j2.close()


def test_journal_truncate_and_clear(tmp_path):
    j = UpdateJournal(str(tmp_path / "g.wal"))
    for k in range(5):
        j.append([k], [k + 1], [1.0], version_before=k)
    assert j.truncate(3) == 3
    assert [r["v0"] for r in j.records()] == [3, 4]
    j.clear()
    assert len(j) == 0
    j.close()


def test_engine_journals_every_committed_update(tmp_path):
    n = 12
    h = graph(n)
    j = UpdateJournal(str(tmp_path / "g.wal"))
    eng = DynamicAPSP(h, journal=j, device="cpu")
    u, v, w = updates(n, 6, seed=1)
    for k in range(6):
        eng.update([int(u[k])], [int(v[k])], [float(w[k])])
    twin = DynamicAPSP(h, device="cpu")
    assert j.replay_onto(twin) == len(j.records())
    assert twin.version == eng.version
    assert torch.equal(twin.dist, eng.dist)
    assert np.array_equal(twin.h, eng.h)
    j.close()


def test_journal_rejected_batch_never_journaled(tmp_path):
    j = UpdateJournal(str(tmp_path / "g.wal"))
    eng = DynamicAPSP(graph(12), journal=j, device="cpu")
    with pytest.raises(Exception):
        eng.update([(0, 1, np.nan)])
    assert len(j) == 0
    eng.update([(0, 1, 1.5)])
    assert len(j) >= 1
    j.close()


@pytest.mark.parametrize("with_pred", [False, True])
def test_engine_checkpoint_roundtrip_bit_exact(tmp_path, with_pred):
    n = 12
    eng = DynamicAPSP(graph(n), with_pred=with_pred, device="cpu")
    eng.update(*updates(n, 4, seed=2))
    save_engine_checkpoint(str(tmp_path), eng)
    st = load_engine_checkpoint(str(tmp_path))
    assert st["version"] == eng.version
    assert st["n"] == n and st["with_pred"] is with_pred
    assert torch.equal(st["dist"], eng.dist)
    assert np.array_equal(st["h"], eng.h)
    if with_pred:
        assert torch.equal(st["pred"], eng.pred)
    twin = DynamicAPSP(st["h"], with_pred=with_pred, state=st, device="cpu")
    assert twin.version == eng.version
    assert torch.equal(twin.dist, eng.dist)


def test_engine_checkpoint_roundtrip_bfloat16(tmp_path):
    eng = DynamicAPSP(graph(12), dtype=torch.bfloat16, device="cpu")
    save_engine_checkpoint(str(tmp_path), eng)
    st = load_engine_checkpoint(str(tmp_path))
    assert st["state_dtype"] == "bfloat16"
    assert st["dist"].dtype == torch.bfloat16
    assert np.array_equal(host(st["dist"]), host(eng.dist))
