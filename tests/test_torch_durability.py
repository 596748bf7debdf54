"""Durability of the port's sessions (the process fault domain) against the
JAX package's.

The same inputs (``kmer_chains(1 << 10, seed=4)``, the numpy oracle's
ranks as ``r0``, ``random_batch`` seeds 100…) go through
``repro.api.PageRankSession`` and ``repro_torch.api.session.PageRankSession``
(``device="cpu"``, the kernels' plain versions).  Twins of
``tests/test_fault_domains.py`` (``TestConfigAxis``'s durability cases,
``TestProcessRecovery`` and the SIGKILL acceptance test) keep the
reference's assertions: a restore is ARRAY-EQUAL to the uninterrupted port
session and replays the same number of batches.  Twins of the fork and
``device_footprint`` cases of ``tests/test_api_session.py`` follow; the
port's fork copies the tile pool where the reference's shares it, so its
twin asserts separate storage.  Then one store per direction crosses the
packages: ``wal.bin``, the ``edges`` leaf and ``meta.json`` byte-identical,
the restored ranks equal to the stored ones, and after the replay within
1e-12 of the other package's uninterrupted session with equal sweep and
edge counters.
"""
import os
import select
import shutil
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.api import SessionStore as JStore
from repro.core import fault_domain as jfd
from repro.core import pagerank as jpr
from repro.core.delta import random_batch
from repro.graphs.generators import kmer_chains, rmat
from repro_torch.api import registry
from repro_torch.api.config import EngineConfig as TConfig
from repro_torch.api.session import PageRankSession as TSession
from repro_torch.ckpt.checkpoint import SessionStore
from repro_torch.core import fault_domain as tfd
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.core.stream import StreamRunner

BLOCK = 64
N_BATCHES = 6
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph():
    jhg = kmer_chains(1 << 10, seed=4)
    return jhg, THostGraph(jhg.n, jhg.edges)


def _r0(jhg):
    return jpr.numpy_reference(jhg.snapshot(block_size=BLOCK),
                               iterations=300)


def _batches(hg, k=N_BATCHES):
    """Deterministic update stream (same seeds in the subprocess script)."""
    out, cur = [], hg
    for i in range(k):
        dels, ins = random_batch(cur, 5e-3, seed=100 + i)
        out.append((dels, ins))
        cur = cur.apply_batch(dels, ins)
    return out, cur


def _oracle_ranks(thg, r0, batches):
    """Per-batch converged ranks of an uninterrupted port pallas session."""
    sess = TSession.from_graph(
        thg, config=TConfig(engine="pallas", block_size=BLOCK), r0=r0,
        device=CPU)
    out = []
    for dels, ins in batches:
        res = sess.update(dels, ins)
        assert res.stats.converged
        out.append(sess.R.numpy().copy())
    return out


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    jhg, thg = _graph()
    r0 = _r0(jhg)
    batches, hg_final = _batches(jhg)
    oracle = _oracle_ranks(thg, r0, batches)
    return thg, r0, batches, hg_final, oracle


def _durable_cfg(**kw):
    base = dict(engine="pallas", block_size=BLOCK, durability="wal",
                checkpoint_interval=3)
    base.update(kw)
    return TConfig.from_kwargs(**base)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ---------------------------------------------------------------------------
# config / domain validation
# ---------------------------------------------------------------------------

class TestConfigAxis:
    def test_durability_validated(self):
        with pytest.raises(ValueError, match="durability"):
            TConfig(durability="paxos")
        with pytest.raises(ValueError, match="checkpoint_interval"):
            TConfig(checkpoint_interval=0)

    def test_durable_session_needs_store_dir(self):
        with pytest.raises(ValueError, match="store_dir"):
            TSession.from_graph(_graph()[1], config=_durable_cfg(),
                                device=CPU)

    def test_durable_snapshot_needs_host_graph(self, tmp_path):
        g = _graph()[1].snapshot(block_size=BLOCK, device=CPU)
        with pytest.raises(ValueError, match="host graph"):
            TSession.from_snapshot(g, config=_durable_cfg(),
                                   store_dir=str(tmp_path / "s"))

    @pytest.mark.parametrize("name", ["blocked", "dense", "pallas"])
    def test_engines_declare_thread_and_process(self, name):
        eng = registry.resolve(name)
        assert registry.fault_domains_of(eng) == ("thread", "process")
        assert tfd.DOMAINS == jfd.DOMAINS

    def test_process_domain_validation(self, tmp_path):
        dom = tfd.ProcessFaultDomain(SessionStore(str(tmp_path / "s")))
        assert dom.name == "process" and dom.checkpoint_interval == 16
        with pytest.raises(ValueError, match="checkpoint_interval"):
            tfd.ProcessFaultDomain(None, checkpoint_interval=0)
        with pytest.raises(ValueError, match="durability"):
            dom.validate_for(topology="single")

    def test_other_domains_name_a_later_item(self):
        class CorruptionLike(tfd.FaultDomain):
            name = "corruption"

        with pytest.raises(NotImplementedError, match="A 11"):
            TConfig(fault_domain=CorruptionLike())

    def test_recovery_record_matches_reference(self):
        kw = dict(domain="process", batch_index=3, wall_time_s=0.25,
                  replayed_batches=2, description="restored")
        assert tfd.RecoveryRecord(**kw).to_dict() == \
            jfd.RecoveryRecord(**kw).to_dict()


# ---------------------------------------------------------------------------
# process fault domain: crash → restore parity
# ---------------------------------------------------------------------------

class TestProcessRecovery:
    def _durable(self, tmp_path, hg, r0, **cfg_kw):
        return TSession.from_graph(
            hg, config=_durable_cfg(**cfg_kw), r0=r0, device=CPU,
            store_dir=str(tmp_path / "store"))

    def _restore(self, tmp_path, name="store"):
        return TSession.restore(str(tmp_path / name), device=CPU)

    def test_restore_replays_wal_to_parity(self, tmp_path, setup):
        hg, r0, batches, _, oracle = setup
        sess = self._durable(tmp_path, hg, r0)     # ckpt every 3 batches
        for dels, ins in batches[:5]:
            sess.update(dels, ins)
        del sess                                    # crash-stop
        rest = self._restore(tmp_path)
        rep = rest.report()
        assert rep.recoveries == 1
        assert rep.replayed_batches == 2            # ckpt@3 + WAL 4..5
        assert rep.recovery_time_s > 0
        np.testing.assert_array_equal(rest.R.numpy(), oracle[4])

    def test_corrupt_checkpoint_leaf_falls_back_and_replays(
            self, tmp_path, setup):
        hg, r0, batches, _, oracle = setup
        sess = self._durable(tmp_path, hg, r0, checkpoint_interval=2)
        for dels, ins in batches[:4]:
            sess.update(dels, ins)                  # ckpts at 2 and 4
        del sess
        store = SessionStore(str(tmp_path / "store"))
        d = os.path.join(store.ckpt.dir, "step_00000004")
        victim = [f for f in os.listdir(d) if f.startswith(
            "params__ranks")][0]
        arr = np.load(os.path.join(d, victim))
        np.save(os.path.join(d, victim), arr + 1e-3)
        rest = self._restore(tmp_path)
        assert rest.report().replayed_batches == 2  # ckpt@2 + WAL 3..4
        np.testing.assert_array_equal(rest.R.numpy(), oracle[3])

    def test_truncated_wal_tail_replays_valid_prefix(self, tmp_path, setup):
        hg, r0, batches, _, oracle = setup
        sess = self._durable(tmp_path, hg, r0, checkpoint_interval=100)
        for dels, ins in batches[:4]:
            sess.update(dels, ins)
        del sess
        store = SessionStore(str(tmp_path / "store"))
        assert store.wal_tip() == 4
        sz = os.path.getsize(store.wal_path)
        with open(store.wal_path, "rb+") as f:
            f.truncate(sz - 11)                     # tear the last record
        assert store.wal_tip() == 3
        rest = self._restore(tmp_path)
        assert rest.report().replayed_batches == 3  # ckpt@0 + WAL 1..3
        np.testing.assert_array_equal(rest.R.numpy(), oracle[2])

    def test_kill_between_checkpoint_and_wal_append(self, tmp_path, setup):
        hg, r0, batches, _, oracle = setup
        sess = self._durable(tmp_path, hg, r0, checkpoint_interval=3)
        for dels, ins in batches[:3]:
            sess.update(dels, ins)     # WAL 1..3 then ckpt@3; nothing after
        del sess
        rest = self._restore(tmp_path)
        assert rest.report().replayed_batches == 0
        np.testing.assert_array_equal(rest.R.numpy(), oracle[2])
        # the stream continues durably from the restored state
        dels, ins = batches[3]
        rest.update(dels, ins)
        np.testing.assert_array_equal(rest.R.numpy(), oracle[3])

    def test_save_and_restore_without_wal(self, tmp_path, setup):
        hg, r0, batches, _, oracle = setup
        sess = TSession.from_graph(
            hg, config=TConfig(engine="pallas", block_size=BLOCK), r0=r0,
            device=CPU)
        for dels, ins in batches[:2]:
            sess.update(dels, ins)
        path = sess.save(str(tmp_path / "snap"))
        assert os.path.exists(path)
        rest = self._restore(tmp_path, "snap")
        assert rest.config.durability == "none" and rest.store is None
        np.testing.assert_array_equal(rest.R.numpy(), oracle[1])
        with pytest.raises(ValueError, match="directory"):
            sess.save()

    def test_rejected_batch_rolls_back_wal(self, tmp_path, setup,
                                           monkeypatch):
        hg, r0, batches, _, oracle = setup
        sess = self._durable(tmp_path, hg, r0, checkpoint_interval=100)
        sess.update(*batches[0])
        store = SessionStore(str(tmp_path / "store"))
        assert store.wal_tip() == 1
        bad_ins = np.array([[sess.n_pad + 3, 0]], np.int64)
        with pytest.raises(ValueError, match="out-of-range"):
            sess.update(np.zeros((0, 2), np.int64), bad_ins)
        assert store.wal_tip() == 1          # rejected pre-append
        real = type(sess)._update_stream

        def _boom(self, *a, **k):
            raise RuntimeError("device fell over mid-apply")
        monkeypatch.setattr(type(sess), "_update_stream", _boom)
        with pytest.raises(RuntimeError, match="mid-apply"):
            sess.update(*batches[1])
        assert store.wal_tip() == 1          # the bad record was revoked
        monkeypatch.setattr(type(sess), "_update_stream", real)
        sess.update(*batches[1])             # the stream continues durably
        del sess
        rest = self._restore(tmp_path)
        assert rest.report().replayed_batches == 2
        np.testing.assert_array_equal(rest.R.numpy(), oracle[1])

    def test_fresh_durable_session_rejects_populated_store(
            self, tmp_path, setup):
        hg, r0, batches, _, _ = setup
        sess = self._durable(tmp_path, hg, r0)
        sess.update(*batches[0])
        sess.close()
        with pytest.raises(ValueError, match="already holds a session"):
            self._durable(tmp_path, hg, r0)
        rest = self._restore(tmp_path)
        assert rest._batch_index == 1

    def test_process_domain_rejected_as_config_axis(self, tmp_path):
        dom = tfd.ProcessFaultDomain(SessionStore(str(tmp_path / "s")),
                                     checkpoint_interval=4)
        with pytest.raises(ValueError, match="durability"):
            TConfig(fault_domain=dom)

    def test_recompute_on_durable_session_checkpoints(
            self, tmp_path, setup):
        hg, r0, batches, _, _ = setup
        sess = self._durable(tmp_path, hg, r0, checkpoint_interval=100)
        sess.update(*batches[0])
        sess.recompute("static")
        served = sess.R.numpy().copy()
        del sess                                # crash-stop
        rest = self._restore(tmp_path)
        np.testing.assert_array_equal(rest.R.numpy(), served)

    def test_fork_detaches_from_store(self, tmp_path, setup):
        hg, r0, batches, _, _ = setup
        sess = self._durable(tmp_path, hg, r0)
        sess.update(*batches[0])
        twin = sess.fork()
        assert twin.store is None and twin.store_dir is None
        store = SessionStore(str(tmp_path / "store"))
        tip = store.wal_tip()
        twin.update(*batches[1])            # must NOT touch the parent WAL
        assert store.wal_tip() == tip


# ---------------------------------------------------------------------------
# durability on every session kind the port runs
# ---------------------------------------------------------------------------

KINDS = {
    "pull": dict(engine="pallas"),
    "push": dict(engine="pallas", driver="push"),
    "snapshot_pallas": dict(engine="pallas"),
    "blocked": dict(engine="blocked"),
    "dense": dict(engine="dense"),
}


def _open(kind, hg, r0, cfg, store_dir=None):
    if kind == "snapshot_pallas":
        g = hg.snapshot(block_size=BLOCK, device=CPU)
        return TSession.from_snapshot(g, config=cfg, r0=r0, hg=hg,
                                      store_dir=store_dir)
    return TSession.from_graph(hg, config=cfg, r0=r0, device=CPU,
                               store_dir=store_dir)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_durable_session_of_every_kind_restores(tmp_path, setup, kind):
    """A durable session of each kind logs and checkpoints; its restore
    (checkpoint 2 + one replayed batch) equals the uninterrupted session
    of the same kind bit for bit (the push restore rebuilds its residual
    from the stored ranks, so it is held within 1e-12 instead)."""
    hg, r0, batches, _, _ = setup
    kw = dict(block_size=BLOCK, **KINDS[kind])
    plain = _open(kind, hg, r0, TConfig(**kw))
    sess = _open(kind, hg, r0, TConfig(durability="wal",
                                       checkpoint_interval=2, **kw),
                 store_dir=str(tmp_path / "s"))
    for dels, ins in batches[:3]:
        plain.update(dels, ins)
        sess.update(dels, ins)
    np.testing.assert_array_equal(sess.R.numpy(), plain.R.numpy())
    del sess
    rest = TSession.restore(str(tmp_path / "s"), device=CPU)
    rep = rest.report()
    assert rep.replayed_batches == 1 and rep.durability == "wal"
    assert rest.engine_name == plain.engine_name
    # restore opens from a host graph, so a snapshot-mode pallas store
    # reopens in stream mode, as the reference's does
    assert rest._stream == (plain._stream or kind == "snapshot_pallas")
    assert rest._push == plain._push
    if kind == "push":
        assert np.abs(rest.R.numpy() - plain.R.numpy()).max() <= 1e-12
    else:
        np.testing.assert_array_equal(rest.R.numpy(), plain.R.numpy())
    rest.update(*batches[3])             # and streams on, durably
    assert SessionStore(str(tmp_path / "s")).wal_tip() == 4


def test_push_restore_matches_reference_restore(tmp_path, setup):
    """A push session's store, written by the reference, restores in both
    packages to ranks and residuals within 1e-12 of each other."""
    hg, r0, batches, _, _ = setup
    jhg = kmer_chains(1 << 10, seed=4)
    js = JSession.from_graph(jhg, config=JConfig(
        engine="pallas", block_size=BLOCK, driver="push", durability="wal",
        checkpoint_interval=2), r0=jnp.asarray(r0),
        store_dir=str(tmp_path / "s"))
    for dels, ins in batches[:3]:
        js.update(dels, ins)
    del js
    shutil.copytree(tmp_path / "s", tmp_path / "s2")
    jr = JSession.restore(str(tmp_path / "s"))
    tr = TSession.restore(str(tmp_path / "s2"), device=CPU)
    assert tr._push and tr.report().replayed_batches == \
        jr.report().replayed_batches == 1
    assert np.abs(tr.R.numpy() - np.asarray(jr.R)).max() <= 1e-12
    assert np.abs(tr._residual.numpy()
                  - np.asarray(jr._residual)).max() <= 1e-12


def test_stream_runner_takes_a_store(tmp_path, setup):
    hg, r0, batches, _, oracle = setup
    runner = StreamRunner(hg, r0=r0, device=CPU, engine="pallas",
                          block_size=BLOCK, durability="wal",
                          checkpoint_interval=100,
                          store_dir=str(tmp_path / "s"))
    runner.step(*batches[0])
    assert SessionStore(str(tmp_path / "s")).wal_tip() == 1
    rest = TSession.restore(str(tmp_path / "s"), device=CPU)
    np.testing.assert_array_equal(rest.R.numpy(), oracle[0])


# ---------------------------------------------------------------------------
# acceptance: SIGKILL a durable subprocess, restore bit for bit
# ---------------------------------------------------------------------------

_CHILD = textwrap.dedent("""
    import sys, time
    import torch
    torch.set_num_threads(1)
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core import pagerank as pr
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import kmer_chains

    store_dir = sys.argv[1]
    hg = kmer_chains(1 << 10, seed=4)
    r0 = pr.numpy_reference(hg.snapshot(block_size=64, device="cpu"),
                            iterations=300)
    cfg = EngineConfig(engine="pallas", block_size=64, durability="wal",
                       checkpoint_interval=100)
    sess = PageRankSession.from_graph(hg, config=cfg, r0=r0, device="cpu",
                                      store_dir=store_dir)
    cur = hg
    for i in range(6):
        dels, ins = random_batch(cur, 5e-3, seed=100 + i)
        if i == 4:
            print("READY", flush=True)      # parent SIGKILLs us here
            time.sleep(120)
        sess.update(dels, ins)
        cur = cur.apply_batch(dels, ins)
""")


@pytest.mark.slow
def test_sigkill_restore_bit_for_bit(tmp_path, setup):
    """The process-domain acceptance bar on the port: SIGKILL a subprocess
    mid-stream, restore its durable session, replay the WAL, finish the
    stream — the final ranks match the uninterrupted session bit for bit
    and the post-restore updates build no kernel."""
    hg, r0, batches, _, oracle = setup
    store_dir = str(tmp_path / "store")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    with open(tmp_path / "child-stderr.log", "w+") as err:
        child = subprocess.Popen(
            [sys.executable, "-c", _CHILD, store_dir], env=env,
            stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            line = ""
            deadline = time.time() + 300
            while "READY" not in line:
                assert time.time() < deadline, "child never became READY"
                ready, _, _ = select.select([child.stdout], [], [], 5.0)
                line = child.stdout.readline() if ready else ""
                if line == "" and child.poll() is not None:
                    err.seek(0)
                    raise AssertionError(
                        f"child died early: {err.read()[-2000:]}")
            os.kill(child.pid, signal.SIGKILL)     # crash-stop, no cleanup
            child.wait(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()

    rest = TSession.restore(store_dir, device=CPU)
    rep = rest.report()
    assert rep.recoveries == 1
    assert rep.replayed_batches == 4           # WAL held batches 1..4
    assert rep.recovery_events[0]["domain"] == "process"
    np.testing.assert_array_equal(rest.R.numpy(), oracle[3])
    for dels, ins in batches[4:]:              # finish the stream here
        res = rest.update(dels, ins)
        assert res.stats.converged
    np.testing.assert_array_equal(rest.R.numpy(), oracle[-1])
    assert rest.report().retraces_post_warmup == 0


# ---------------------------------------------------------------------------
# twins of the fork and device_footprint cases of tests/test_api_session.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dyn():
    hg0 = rmat(9, avg_degree=6, seed=5)
    r_prev = jpr.numpy_reference(hg0.snapshot(block_size=64),
                                 iterations=300)
    dels, ins = random_batch(hg0, 5e-3, seed=21)
    return THostGraph(hg0.n, hg0.edges), r_prev, dels, ins


def _storage(mat):
    return {t.untyped_storage().data_ptr() for t in (
        mat.tiles, mat.tile_cols, mat.tile_idx, mat.index.off,
        mat.index.cnt, mat.index.row, mat.index.col, mat.index.val)}


def test_fork_branches_are_independent(dyn):
    hg0, r_prev, dels, ins = dyn
    sess = TSession.from_graph(
        hg0, config=TConfig(engine="pallas", block_size=64), r0=r_prev,
        device=CPU)
    base_m = sess.hg.m
    base_R = sess.R.numpy().copy()
    twin = sess.fork()
    # the port patches in place, so the fork owns a copy of every tensor a
    # later update writes (the reference shares its immutable pool)
    assert not _storage(twin.inc.mat) & _storage(sess.inc.mat)
    for a in ("R", "valid", "_out_deg", "_rb_in", "_rb_out", "_bmat"):
        assert (getattr(twin, a).untyped_storage().data_ptr()
                != getattr(sess, a).untyped_storage().data_ptr()), a
    assert twin.inc.mat.index.bound_h is not sess.inc.mat.index.bound_h
    assert twin._out_deg_host is not sess._out_deg_host
    twin.update(dels, ins)
    # parent untouched by the fork's update
    assert sess.hg.m == base_m
    np.testing.assert_array_equal(sess.R.numpy(), base_R)
    np.testing.assert_array_equal(
        sess._out_deg.numpy(),
        sess.hg.snapshot(block_size=64, device=CPU).out_deg.numpy())
    # both branches keep converging independently
    d2, i2 = random_batch(sess.hg, 5e-3, seed=77)
    assert sess.update(d2, i2).stats.converged
    assert twin.report().n_updates == 1
    assert sess.report().n_updates == 1


def test_fork_equals_the_parent_given_the_same_batch(dyn):
    """Forks of a pull and a push session, given the parent's next batch,
    land on the parent's ranks bit for bit (and the push fork on its
    residual), while the parent's pool and index stay as they were."""
    hg0, r_prev, dels, ins = dyn
    for driver in ("pull", "push"):
        sess = TSession.from_graph(
            hg0, config=TConfig(block_size=64, driver=driver), r0=r_prev,
            device=CPU)
        sess.update(dels, ins)
        twin = sess.fork()
        tiles0 = sess.inc.mat.tiles.clone()
        val0 = sess.inc.mat.index.val.clone()
        d2, i2 = random_batch(sess.hg, 5e-3, seed=78)
        twin.update(d2, i2)
        assert torch.equal(sess.inc.mat.tiles, tiles0)
        assert torch.equal(sess.inc.mat.index.val, val0)
        sess.update(d2, i2)
        assert torch.equal(twin.R, sess.R), driver
        if driver == "push":
            assert torch.equal(twin._residual, sess._residual)


def test_recompute_variants_and_fork(dyn):
    """Twin of the reference's case (there on a one-shard sharded session,
    a later slice here; the port runs it on the single-device pallas
    session)."""
    hg0, r_prev, dels, ins = dyn
    sess = TSession.from_graph(
        hg0, config=TConfig(engine="pallas", block_size=64), r0=r_prev,
        device=CPU)
    with pytest.raises(ValueError, match="no batch"):
        sess.recompute("df")
    out = sess.update(dels, ins)
    replay = sess.recompute("df")
    np.testing.assert_array_equal(out.ranks.numpy(), replay.ranks.numpy())
    static = sess.recompute("static")
    assert static.stats.converged
    twin = sess.fork()
    d2, i2 = random_batch(sess.hg, 5e-3, seed=88)
    twin.update(d2, i2)
    assert sess.report().n_updates == 1     # parent untouched
    assert twin.report().n_updates == 1
    assert sess.hg.m != twin.hg.m or not np.array_equal(
        sess.R.numpy(), twin.R.numpy())


def test_fork_of_a_snapshot_session(dyn):
    hg0, r_prev, dels, ins = dyn
    sess = TSession.from_graph(
        hg0, config=TConfig(engine="blocked", block_size=64), r0=r_prev,
        device=CPU)
    base_R = sess.R.numpy().copy()
    twin = sess.fork()
    twin.update(dels, ins)
    np.testing.assert_array_equal(sess.R.numpy(), base_R)
    sess.update(dels, ins)
    np.testing.assert_array_equal(twin.R.numpy(), sess.R.numpy())


def test_close_is_idempotent_and_guards_reads(dyn):
    hg0, r_prev, _, _ = dyn
    sess = TSession.from_graph(
        hg0, config=TConfig(engine="blocked"), r0=r_prev, device=CPU)
    assert sess.device_footprint == (0,)      # the reference's CPU answer
    sess.close()
    sess.close()
    assert sess.closed and sess.device_footprint == ()
    for call in (lambda: sess.query([0]), lambda: sess.top_k(1),
                 lambda: sess.update([], []),
                 lambda: sess.recompute("static"), lambda: sess.fork(),
                 lambda: sess.ranks, lambda: sess.save("x")):
        with pytest.raises(ValueError, match="closed"):
            call()
    assert sess.R is None and sess.inc is None   # buffers dropped


def test_device_footprint_matches_reference(dyn, tmp_path):
    hg0, r_prev, _, _ = dyn
    js = JSession.from_graph(rmat(9, avg_degree=6, seed=5),
                             config=JConfig(engine="pallas", block_size=64),
                             r0=jnp.asarray(r_prev))
    ts = TSession.from_graph(hg0, config=TConfig(block_size=64), r0=r_prev,
                             device=CPU, store_dir=None)
    assert ts.device_footprint == js.device_footprint == (0,)
    durable = TSession.from_graph(
        hg0, config=TConfig(block_size=64, durability="wal"), r0=r_prev,
        device=CPU, store_dir=str(tmp_path / "s"))
    durable.close()
    assert durable.store is None and durable._process_domain is None
    assert durable.device_footprint == ()


# ---------------------------------------------------------------------------
# stores across the packages
# ---------------------------------------------------------------------------

def _histories(tmp_path, setup, k=3):
    """The same durable history (pallas pull, checkpoint every 2 batches,
    ``k`` updates) in each package; returns both sessions and stores."""
    hg, r0, batches, _, _ = setup
    jhg = kmer_chains(1 << 10, seed=4)
    js = JSession.from_graph(jhg, config=JConfig(
        engine="pallas", block_size=BLOCK, durability="wal",
        checkpoint_interval=2), r0=jnp.asarray(r0),
        store_dir=str(tmp_path / "j"))
    ts = TSession.from_graph(hg, config=TConfig(
        engine="pallas", block_size=BLOCK, durability="wal",
        checkpoint_interval=2), r0=r0, device=CPU,
        store_dir=str(tmp_path / "t"))
    jres, tres = [], []
    for dels, ins in batches[:k]:
        jres.append(js.update(dels, ins))
        tres.append(ts.update(dels, ins))
    return js, ts, jres, tres


def _assert_same_files(tmp_path):
    j, t = tmp_path / "j", tmp_path / "t"
    assert _same_bytes(j / "wal.bin", t / "wal.bin")
    assert _same_bytes(j / "meta.json", t / "meta.json")
    steps = sorted(os.listdir(j / "ckpt"))
    assert steps == sorted(os.listdir(t / "ckpt")) == [
        "step_00000000", "step_00000002"]
    for s in steps:
        assert _same_bytes(j / "ckpt" / s / "params__edges.npy",
                           t / "ckpt" / s / "params__edges.npy")


def _wal_without_tail(src, dst):
    """A copy of store ``src`` whose WAL stops at its latest checkpoint."""
    shutil.copytree(src, dst)
    store = SessionStore(str(dst))
    idx = store.latest_checkpoint_index
    store.truncate_wal(sum(
        len(SessionStore._encode_record(r.batch_index, r.variant,
                                        r.deletions, r.insertions))
        for r in store.read_wal() if r.batch_index <= idx))
    assert store.read_wal(after=idx) == []
    return store


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_store_crosses_packages(tmp_path, setup, writer):
    """One package writes a durable store, the other restores it: the files
    are the same in both, the restored ranks are the stored ones exactly,
    and after the replay of batch 3 they are within 1e-12 of the other
    package's uninterrupted session, with its sweeps and edges."""
    js, ts, jres, tres = _histories(tmp_path, setup)
    _assert_same_files(tmp_path)
    src = tmp_path / ("j" if writer == "repro" else "t")
    # the writer's uninterrupted session on batch 3 is the one to track
    live_R = np.asarray(js.R) if writer == "repro" else ts.R.numpy()
    live = jres[-1] if writer == "repro" else tres[-1]
    store = _wal_without_tail(src, tmp_path / "no_tail")
    stored, idx = store.restore_latest_state()
    assert idx == 2
    if writer == "repro":
        at_ckpt = TSession.restore(str(tmp_path / "no_tail"), device=CPU)
        full = TSession.restore(str(src), device=CPU)
        got = (at_ckpt.R.numpy(), full.R.numpy())
    else:
        at_ckpt = JSession.restore(str(tmp_path / "no_tail"))
        full = JSession.restore(str(src))
        got = (np.asarray(at_ckpt.R), np.asarray(full.R))
    n = store.read_meta()["n"]
    np.testing.assert_array_equal(got[0][:n], stored["ranks"])
    assert at_ckpt._batch_index == 2 and full._batch_index == 3
    rep = full.report()
    assert rep.replayed_batches == 1 and rep.n_updates == 1
    assert np.abs(got[1] - live_R).max() <= 1e-12
    assert rep.total_sweeps == live.stats.sweeps
    assert rep.total_edges_processed == live.stats.edges_processed
    np.testing.assert_array_equal(full.hg.edges, ts.hg.edges)


def test_store_meta_is_the_reference_config_echo(tmp_path, setup):
    """meta.json carries every config field but the injection schedules,
    with ``dtype`` by its numpy name, and each package reads it back."""
    hg, r0, _, _, _ = setup
    ts = TSession.from_graph(hg, config=TConfig(
        engine="pallas", block_size=BLOCK, durability="wal",
        dtype=torch.float64, tau=1e-9), r0=r0, device=CPU,
        store_dir=str(tmp_path / "t"))
    meta = SessionStore(str(tmp_path / "t")).read_meta()
    assert meta["config"]["dtype"] == "float64"
    assert set(meta["config"]) == {
        f for f in TConfig.valid_keys() if f not in ("faults",
                                                     "fault_domain")}
    assert meta["n"] == hg.n and meta["kind"] == "pagerank-session"
    assert JConfig.from_kwargs(**meta["config"]).tau == 1e-9
    assert TConfig.from_kwargs(**meta["config"]).resolved_dtype() == \
        torch.float64
    js = JSession.restore(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(js.R)[:hg.n],
                                  ts.R.numpy()[:hg.n])
    assert JStore(str(tmp_path / "t")).latest_checkpoint_index == 0
