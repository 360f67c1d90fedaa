"""The port's checkpoint files against the JAX package's.

``repro_torch.checkpoint``: the twins of ``tests/test_checkpoint.py``'s seven
tests on the port's tensors, and the on-disk format shared byte for byte:
a checkpoint the JAX package writes restores into the port's state and the
reverse, the two manifests equal and the npz members equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from repro.checkpoint import ckpt as r_ckpt
from repro.configs import RunConfig as RRunConfig
from repro.configs import get_config as r_get_config
from repro.configs import reduce_for_smoke as r_reduce
from repro.models import build as r_build
from repro.train import step as r_step
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    reshape_nodes, restore, save)
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import dpsgd as t_dpsgd
from repro_torch.models import build
from repro_torch.train import step as t_step


def _state(seed=0, n_nodes=4):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(n_nodes, 8, 3))
                                         .astype(np.float32)),
                   "b": torch.ones((n_nodes, 3))},
        "opt": {"v": torch.zeros((n_nodes, 8, 3))},
        "step": torch.tensor(17, dtype=torch.int32),
    }


def _leaves(tree):
    return t_dpsgd._leaves(tree)


def test_save_restore_roundtrip(tmp_path):
    state = _state()
    save(str(tmp_path), 17, state)
    restored, step = restore(str(tmp_path), state)
    assert step == 17
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_restore_latest_of_many(tmp_path):
    for s in (5, 10, 15):
        save(str(tmp_path), s, _state(seed=s))
    assert latest_step(str(tmp_path)) == 15
    _, step = restore(str(tmp_path), _state())
    assert step == 15


def test_digest_mismatch_detected(tmp_path):
    state = _state()
    path = save(str(tmp_path), 1, state)
    data = dict(np.load(os.path.join(path, "host0.npz")))
    data["leaf_0"] = data["leaf_0"] + 1
    with open(os.path.join(path, "host0.npz"), "wb") as f:
        np.savez(f, **data)
    with pytest.raises(ValueError, match="digest"):
        restore(str(tmp_path), state)


def test_incomplete_checkpoint_ignored(tmp_path):
    save(str(tmp_path), 3, _state())
    # a later, incomplete step (no MANIFEST) must be skipped
    os.makedirs(tmp_path / "step_00000009")
    _, step = restore(str(tmp_path), _state())
    assert step == 3
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "missing"), _state())


def test_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(seed=s))
    mgr.wait()
    mgr._gc()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4]
    assert not [n for n in os.listdir(tmp_path / "step_00000004")
                if n.startswith(".tmp-")]


def test_manager_snapshot_is_taken_at_save(tmp_path):
    """The manager copies the state off the tensors when ``save`` is
    called: a later in-place change of a CPU tensor is not written."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _state()
    want = state["params"]["w"].clone()
    mgr.save(1, state)
    state["params"]["w"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore_latest(_state())
    assert torch.equal(restored["params"]["w"], want)


def test_elastic_reshape_nodes():
    state = _state(n_nodes=4)
    # node 2 dies; restore onto 4 nodes again (replacement warm start)
    out = reshape_nodes(state, survivors=[0, 1, 3], n_new=4)
    w = out["params"]["w"].numpy()
    orig = state["params"]["w"].numpy()
    np.testing.assert_array_equal(w[:3], orig[[0, 1, 3]])
    np.testing.assert_allclose(w[3], orig[[0, 1, 3]].mean(0), rtol=1e-6)
    assert int(out["step"]) == 17
    # shrink to 3 nodes
    out3 = reshape_nodes(state, survivors=[0, 1, 3], n_new=3)
    assert out3["params"]["w"].shape[0] == 3


def test_restart_resumes_data_stream(tmp_path):
    """Deterministic batches: step k gives identical data across restarts,
    equal to the JAX package's stream."""
    from repro.data.pipeline import deterministic_lm_batch as r_batch
    from repro_torch.data.pipeline import deterministic_lm_batch
    b1 = deterministic_lm_batch(42, 4, 16, 1000, seed=7)
    b2 = deterministic_lm_batch(42, 4, 16, 1000, seed=7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["tokens"],
                                  r_batch(42, 4, 16, 1000, seed=7)["tokens"])


# ---------------------------------------------------------------------------
# One format for both packages
# ---------------------------------------------------------------------------

def _train_states():
    """A Mode B adamw state with int8 residuals of the qwen2-vl-2b smoke
    config, the JAX package's (numpy leaves) and a port state of the same
    structure drawn from another seed."""
    kw = dict(mode="dpsgd", compression="int8", optimizer="adamw",
              remat="none")
    jcfg = r_reduce(r_get_config("qwen2-vl-2b"))
    jstate = r_step.init_train_state(r_build(jcfg), RRunConfig(**kw),
                                     jax.random.key(3), n_nodes=4)
    jstate["step"] = jnp.asarray(5, jnp.int32)
    jstate["opt"]["t"] = jnp.asarray(5, jnp.int32)
    jstate = jax.tree.map(np.asarray, jstate)
    tcfg = reduce_for_smoke(get_config("qwen2-vl-2b"))
    tstate = t_step.init_train_state(build(tcfg, "cpu"), RunConfig(**kw),
                                     torch.Generator().manual_seed(9),
                                     n_nodes=4)
    return jstate, tstate


def _files(step_dir):
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(step_dir, "host0.npz")) as data:
        members = {k: data[k] for k in data.files}
    return manifest, members


def test_jax_checkpoint_restores_into_port_state_and_back(tmp_path):
    """The JAX package writes a train state; the port restores it into its
    own state's structure (every leaf equal, in jax.tree order), saves it
    again, and the JAX package restores that: the manifests equal and the
    npz members equal, member for member."""
    jstate, tstate = _train_states()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    r_ckpt.save(jdir, 5, jstate)
    got, step = restore(jdir, tstate)
    assert step == 5
    want = jax.tree.leaves(jstate)
    assert len(_leaves(got)) == len(want)
    for a, b in zip(_leaves(got), want):
        assert str(a.dtype)[6:] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), b)

    save(tdir, 5, got)
    back, step = r_ckpt.restore(tdir, jstate)
    assert step == 5
    for a, b in zip(jax.tree.leaves(back), want):
        np.testing.assert_array_equal(np.asarray(a), b)
    j_manifest, j_members = _files(os.path.join(jdir, "step_00000005"))
    t_manifest, t_members = _files(os.path.join(tdir, "step_00000005"))
    assert t_manifest == j_manifest
    assert list(t_members) == list(j_members)
    for k in j_members:
        assert t_members[k].dtype == j_members[k].dtype
        np.testing.assert_array_equal(t_members[k], j_members[k])


def test_port_checkpoint_restores_into_jax_state(tmp_path):
    """The reverse direction from a state the port drew: the JAX package
    restores it (digest checked) with every leaf equal."""
    jstate, tstate = _train_states()
    save(str(tmp_path), 2, tstate)
    back, step = r_ckpt.restore(str(tmp_path), jstate)
    assert step == 2
    for a, b in zip(jax.tree.leaves(back), _leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert r_ckpt.latest_step(str(tmp_path)) == latest_step(str(tmp_path))
    restored, _ = restore(str(tmp_path), params_from_numpy(jstate, "cpu"))
    for a, b in zip(_leaves(restored), _leaves(tstate)):
        assert torch.equal(a, b)


def _members_raw(step_dir):
    import zipfile
    with zipfile.ZipFile(os.path.join(step_dir, "host0.npz")) as z:
        return {name: z.read(name) for name in z.namelist()}


def test_bfloat16_leaves_cross_packages(tmp_path):
    """A state with bfloat16 leaves (phi3.5-moe's parameter dtype): the
    JAX package's checkpoint restores into the port bit for bit, the
    port's own round trip keeps the bits and the dtype, and both packages
    write the same manifest and the same npz members, byte for byte."""
    w = np.random.default_rng(4).normal(size=(4, 8, 3)).astype(np.float32)
    jstate = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                         "b": jnp.full((4, 3), -1.5, jnp.bfloat16)},
              "opt": {"m": jnp.asarray(w)},
              "step": jnp.asarray(3, jnp.int32)}
    tstate = {"params": {"w": torch.from_numpy(w).to(torch.bfloat16),
                         "b": torch.full((4, 3), -1.5,
                                         dtype=torch.bfloat16)},
              "opt": {"m": torch.from_numpy(w)},
              "step": torch.tensor(3, dtype=torch.int32)}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    r_ckpt.save(jdir, 3, jstate)
    got, step = restore(jdir, tstate)
    assert step == 3
    for a, b in zip(_leaves(got), jax.tree.leaves(jstate)):
        b = np.asarray(b)
        assert str(a.dtype)[6:] == str(b.dtype)
        if a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)
    save(tdir, 3, tstate)
    back, _ = restore(tdir, tstate)
    for a, b in zip(_leaves(back), _leaves(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    j_dir, t_dir = (os.path.join(d, "step_00000003") for d in (jdir, tdir))
    assert _files(t_dir)[0] == _files(j_dir)[0]
    assert _files(t_dir)[0]["dtypes"] == ["float32", "bfloat16", "bfloat16",
                                          "int32"]
    assert _members_raw(t_dir) == _members_raw(j_dir)


@pytest.mark.parametrize("n", [3, 4, 9])
def test_bfloat16_node_surgery_matches_reference(n):
    """``reshape_nodes`` and ``expand_nodes`` on bfloat16 leaves: the
    survivors' mean bit-equal to the JAX package's (numpy's mean of its
    ml_dtypes arrays), float32 leaves beside them too."""
    from repro_torch.checkpoint import expand_nodes
    rng = np.random.default_rng(n)
    w = (rng.normal(size=(n, 6, 5)) * 30).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    jstate = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b,
                                                                jnp.bfloat16),
              "f": jnp.asarray(w)}
    tstate = {"w": torch.from_numpy(w).to(torch.bfloat16),
              "b": torch.from_numpy(b).to(torch.bfloat16),
              "f": torch.from_numpy(w)}
    survivors = list(range(n - 1))
    for got, want in (
            (reshape_nodes(tstate, survivors, n),
             r_ckpt.reshape_nodes(jstate, survivors, n)),
            (expand_nodes(tstate, list(range(n)), n + 2),
             r_ckpt.expand_nodes(jstate, list(range(n)), n + 2))):
        for a, r in zip(_leaves(got), jax.tree.leaves(want)):
            r = np.asarray(r)
            assert str(a.dtype)[6:] == str(r.dtype)
            bits = np.int16 if a.dtype == torch.bfloat16 else np.int32
            np.testing.assert_array_equal(
                a.view(torch.int16 if bits is np.int16 else torch.int32)
                .numpy(), r.view(bits))
