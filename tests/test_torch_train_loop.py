"""The port's checkpointer and training loop (``repro_torch.checkpoint``,
``repro_torch.launch.train``, ``examples/torch_train_lm.py``) on the CPU,
and checkpoints moved between the port and the reference.

The checkpoint cases are the reference's ``tests/test_checkpoint.py``
(all but the sharded-mesh restore, which waits for the port's mesh) on
trees of tensors, bf16 leaves included.  A checkpoint written by either
package restores in the other.  Three whole train steps from the same
weights match the reference's (loss and gradient norm within 1e-5
relative: the global norm sums per-layer leaves here, layer-stacked ones
there); a training run resumed across packages takes its third step
within 1e-5 relative of the other's (loss and gradient norm; the
parameters within 1e-6).  The port's own restart is held bit for bit.
"""

import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import adamw as jopt
from repro_torch import configs, interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data import pipeline as data
from repro_torch.launch import steps
from repro_torch.launch.train import train
from repro_torch.optim import adamw as opt
from repro_torch.optim import tree as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
ARCH = "smollm-135m"
ARCHS = ("smollm-135m", "moonshot-v1-16b-a3b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4),
                   "b": torch.ones(4),
                   "h": torch.linspace(-3, 3, 6).to(torch.bfloat16),
                   "blocks": [{"a": torch.full((2,), float(i))}
                              for i in range(3)]},
        "opt": {"mu": {"w": torch.zeros(3, 4)},
                "count": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_trees_equal(a, b):
    fa, fb = T.flatten(a), T.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


# ---------------------------------------------------------------------------
# the reference's checkpoint cases
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    ck.save(10, tree, blocking=True)
    step, restored = ck.restore(None, tree)
    assert step == 10
    _assert_trees_equal(tree, restored)
    manifest = json.loads((tmp_path / "step_00000010" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 10 and manifest["n_hosts"] == 1
    assert manifest["arrays"]["params/h"]["dtype"] == "bfloat16"
    assert manifest["arrays"]["params/blocks/2/a"]["shape"] == [2]
    assert manifest["arrays"]["opt/count"]["dtype"] == "int32"


def test_restore_onto_meta_like_and_device(tmp_path, tree):
    """``like`` may be meta tensors (shapes and dtypes only); ``device``
    places every leaf."""
    ck = Checkpointer(tmp_path)
    ck.save(1, tree, blocking=True)
    like = T.map_tree(lambda t: torch.empty_like(t, device="meta"), tree)
    _, restored = ck.restore(1, like, device="cpu")
    _assert_trees_equal(tree, restored)


def test_async_save_then_wait(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    ck.save(1, tree, blocking=False)
    ck.wait()
    assert ck.latest_step() == 1


def test_async_save_copies_before_returning(tmp_path, tree):
    """The host copy is made in ``save``: an in-place update right after
    it (the next train step) does not reach the checkpoint."""
    ck = Checkpointer(tmp_path)
    want = T.map_tree(torch.clone, tree)
    ck.save(1, tree, blocking=False)
    for t in T.flatten(tree).values():
        t.add_(1)
    ck.wait()
    _assert_trees_equal(want, ck.restore(1, tree)[1])


def test_retention_keeps_newest(tmp_path, tree):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree, blocking=True)
    assert ck.all_steps() == [3, 4]


def test_atomic_no_partial_visible(tmp_path, tree):
    """A temp dir from a dead writer must not count as a checkpoint."""
    ck = Checkpointer(tmp_path)
    ck.save(5, tree, blocking=True)
    (tmp_path / ".tmp-9-0").mkdir()          # simulated dead writer
    assert ck.latest_step() == 5


def test_corruption_detected(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    ck.save(3, tree, blocking=True)
    f = tmp_path / "step_00000003" / "host0.npz"
    data_ = bytearray(f.read_bytes())
    data_[len(data_) // 2] ^= 0xFF
    f.write_bytes(bytes(data_))
    with pytest.raises((IOError, ValueError, Exception)):
        ck.restore(3, tree)


def test_missing_array_detected(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    ck.save(3, tree, blocking=True)
    extra = dict(tree)
    extra["new_thing"] = torch.zeros(2)
    with pytest.raises(KeyError):
        ck.restore(3, extra)


def test_restore_shape_mismatch_raises(tmp_path, tree):
    ck = Checkpointer(tmp_path)
    ck.save(1, tree, blocking=True)
    bad = T.map_tree(lambda a: a, tree)
    bad["params"]["w"] = torch.zeros(5, 5)
    with pytest.raises(ValueError):
        ck.restore(1, bad)


def test_checkpoints_cross_packages(tmp_path):
    """The same arrays written by either package: the same manifest (bf16
    as its raw words under dtype "bfloat16", the same crc32), and each
    package restores the other's (the reference cannot cast a bf16 entry
    back, its own included, so its side is f32 / int32)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal(6).astype(ml_dtypes.bfloat16)
    jtree = {"p": {"w": w, "h": h}, "count": np.int32(5)}
    ttree = {"p": {"w": torch.from_numpy(w),
                   "h": torch.from_numpy(h.astype(np.float32))
                   .to(torch.bfloat16)},
             "count": torch.tensor(5, dtype=torch.int32)}
    JCheckpointer(tmp_path / "ref").save(2, jtree, blocking=True)
    Checkpointer(tmp_path / "port").save(2, ttree, blocking=True)
    m_ref, m_port = (json.loads((tmp_path / d / "step_00000002" /
                                 "manifest.json").read_text())
                     for d in ("ref", "port"))
    assert m_ref == m_port
    _, got = Checkpointer(tmp_path / "ref").restore(2, ttree)
    _assert_trees_equal(ttree, got)
    del jtree["p"]["h"]
    _, back = JCheckpointer(tmp_path / "port").restore(2, jtree)
    np.testing.assert_array_equal(np.asarray(back["p"]["w"]), w)
    assert int(back["count"]) == 5


# ---------------------------------------------------------------------------
# whole train steps, and a training run resumed across packages
# ---------------------------------------------------------------------------

def _model(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, "cpu", trainable=True)
    return cfg, jcfg, params, jparams


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    """``steps.make_train_step`` against the reference's jitted step, 3
    steps from the same weights: loss and gradient norm within 1e-5
    relative at every step."""
    cfg, jcfg, params, jparams = _model(arch)
    ocfg = dict(lr=1e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.OptimizerConfig(
        **ocfg)))
    jstate = jopt.init(jopt.OptimizerConfig(**ocfg), jparams)
    step = steps.make_train_step(cfg, opt.OptimizerConfig(**ocfg))
    state = opt.init(opt.OptimizerConfig(**ocfg), params.tree())
    for s in range(3):
        b = data.batch_at(data.DataConfig(vocab=cfg.vocab, seq_len=32,
                                          global_batch=2), s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) <= TOL * abs(float(jm[k]))
    assert int(state["count"]) == 3


def _batches(cfg, n):
    return [data.batch_at(data.DataConfig(vocab=cfg.vocab, seq_len=16,
                                          global_batch=2), s)
            for s in range(n)]


def _as_tensors(tree):
    return T.map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages(tmp_path, writer):
    """Two AdamW steps in one package, a ``{params, opt}`` checkpoint by
    its own checkpointer, restored in the other (through ``interop``'s
    layer-stacked layout, the reference's key paths), then each package's
    third step from there: loss and gradient norm within 1e-5 relative,
    new parameters within 1e-6."""
    jcfg, cfg = (jconfigs.get_smoke_config(ARCH),
                 configs.get_smoke_config(ARCH))
    ocfg = dict(lr=1e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.OptimizerConfig(
        **ocfg)))
    step = steps.make_train_step(cfg, opt.OptimizerConfig(**ocfg))
    batches = _batches(cfg, 3)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    jstate = jopt.init(jopt.OptimizerConfig(**ocfg), jparams)
    if writer == "reference":
        for b in batches[:2]:
            jparams, jstate, _ = jstep(jparams, jstate,
                                       {k: jnp.asarray(v)
                                        for k, v in b.items()})
        JCheckpointer(tmp_path).save(2, {"params": jparams, "opt": jstate},
                                     blocking=True)
        like = _as_tensors({"params": jax.tree.map(np.asarray, jparams),
                            "opt": jax.tree.map(np.asarray, jstate)})
        at, got = Checkpointer(tmp_path).restore(None, like)
        got = T.map_tree(lambda t: t.numpy(), got)
        params = interop.lm_params_from_numpy(got["params"], cfg, "cpu",
                                              trainable=True)
        state = interop.opt_state_from_numpy(got["opt"], cfg, "cpu")
    else:
        params = interop.lm_params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, "cpu", trainable=True)
        state = opt.init(opt.OptimizerConfig(**ocfg), params.tree())
        for b in batches[:2]:
            params, state, _ = step(params, state,
                                    {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        Checkpointer(tmp_path).save(2, _as_tensors(
            {"params": interop.lm_params_to_numpy(params),
             "opt": interop.opt_state_to_numpy(state)}), blocking=True)
        at, got = JCheckpointer(tmp_path).restore(
            None, {"params": jparams, "opt": jstate})
        jparams, jstate = got["params"], got["opt"]
    assert at == 2 and int(state["count"]) == int(jstate["count"]) == 2
    b = batches[2]
    jparams, jstate, jm = jstep(jparams, jstate,
                                {k: jnp.asarray(v) for k, v in b.items()})
    params, state, m = step(params, state,
                            {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= TOL * abs(float(jm[k]))
    got = interop.lm_params_to_numpy(params)
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jparams))[0]:
        err = np.abs(T.get(got, tuple(k.key for k in path)) - want).max()
        assert err <= 1e-6, (path, err)


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def test_loss_decreases(tmp_path):
    """The synthetic stream's bigram structure is learnable, so the loss
    drops below its t=0 plateau of ~log(vocab) within a few dozen steps."""
    out = train(ARCH, steps=40, batch=4, seq_len=32, ckpt_dir=str(tmp_path),
                ckpt_every=100, lr=3e-3, device="cpu")
    first = np.mean(out["losses"][:4])
    last = np.mean(out["losses"][-4:])
    assert last < first - 0.05, (first, last)
    assert out["final_step"] == 40 and len(out["losses"]) == 40


def test_restart_is_bit_exact(tmp_path):
    """12 steps straight against 6, a restart, and 6 more: the same final
    loss and the same parameters and state at step 12, bit for bit."""
    kw = dict(steps=12, batch=2, seq_len=16, device="cpu")
    a = train(ARCH, ckpt_dir=str(tmp_path / "a"), ckpt_every=100, **kw)
    b1 = train(ARCH, ckpt_dir=str(tmp_path / "b"), ckpt_every=6,
               **{**kw, "steps": 6})
    assert b1["final_step"] == 6
    b2 = train(ARCH, ckpt_dir=str(tmp_path / "b"), ckpt_every=6, **kw)
    assert b2["final_step"] == 12 and len(b2["losses"]) == 6
    assert a["losses"][-1] == b2["losses"][-1]
    assert a["losses"][6:] == b2["losses"]
    ca, cb = Checkpointer(tmp_path / "a"), Checkpointer(tmp_path / "b")
    assert ca.latest_step() == cb.latest_step() == 12
    npz = [np.load(d / "step_00000012" / "host0.npz") for d in
           (tmp_path / "a", tmp_path / "b")]
    assert sorted(npz[0].files) == sorted(npz[1].files)
    for k in npz[0].files:
        np.testing.assert_array_equal(npz[0][k], npz[1][k])


def _run(argv, tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)}
    return subprocess.run([sys.executable, *argv], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)


def test_simulated_failure_and_recovery(tmp_path):
    """Kill the trainer mid-run (exit 42), restart, reach the target: the
    crash/restart path end to end, as its own processes."""
    cmd = ["-m", "repro_torch.launch.train", "--arch", ARCH, "--steps",
           "10", "--batch", "2", "--seq-len", "16", "--ckpt-dir",
           str(tmp_path / "ck"), "--ckpt-every", "4", "--device", "cpu"]
    r1 = _run(cmd + ["--simulate-failure", "5"], tmp_path)
    assert r1.returncode == 42, r1.stderr[-500:]
    assert "SIMULATED FAILURE at step 5" in r1.stdout
    assert Checkpointer(tmp_path / "ck").all_steps() == [4]
    r2 = _run(cmd + ["--json", str(tmp_path / "out.json")], tmp_path)
    assert r2.returncode == 0, r2.stderr[-500:]
    assert "resumed from step 4" in r2.stdout
    assert "done: step 10" in r2.stdout
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["final_step"] == 10 and len(out["losses"]) == 6
    straight = train(ARCH, steps=10, batch=2, seq_len=16, ckpt_every=4,
                     ckpt_dir=str(tmp_path / "straight"), device="cpu")
    assert straight["losses"][4:] == out["losses"]


def test_example_trains(tmp_path):
    """``examples/torch_train_lm.py`` on the CPU: exit 0 with its loss
    line (it asserts that the loss fell)."""
    r = _run([str(ROOT / "examples" / "torch_train_lm.py"), "--device",
              "cpu", "--steps", "40", "--ckpt-dir", str(tmp_path / "ck")],
             tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert "[example] loss" in r.stdout and "over 40 steps" in r.stdout
