"""The port's checkpoints and durable-session store against the JAX package's.

``repro_torch.ckpt.checkpoint`` keeps its own copy of
``repro.ckpt.checkpoint`` without JAX.  Twins of the checkpoint tests of
``tests/test_ckpt_and_substrate.py`` and of
``tests/test_fault_domains.py::TestStoreCorruption`` run on the port with
the reference's assertions; then the files on disk are held byte for byte
to the reference's: the leaf keys and ``.npy`` files of a checkpoint, its
manifest, every WAL frame, and a WAL written by one package read by the
other.
"""
import os
import zlib

import numpy as np
import pytest
import jax
import torch

from repro.ckpt import checkpoint as jck
from repro_torch.ckpt import checkpoint as tck
from repro_torch.ckpt.checkpoint import Checkpointer, SessionStore


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0):
    """The reference test's tree, made by JAX, as numpy leaves."""
    k = jax.random.PRNGKey(seed)
    return {"w": np.asarray(jax.random.normal(k, (8, 8))),
            "nested": {"b": np.arange(5, dtype=np.float32)}}


def _leaves(tree):
    return list(tck._flatten_with_paths(tree).values())


# ---------------------------------------------------------------------------
# twins of tests/test_ckpt_and_substrate.py (checkpointing)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    p = _params()
    opt = {"m": {"w": np.zeros((8, 8), np.float32),
                 "nested": {"b": np.zeros(5, np.float32)}},
           "step": np.int32(7)}
    ck.save(p, opt, 10)
    p2, opt2, step = ck.restore(10, p, opt)
    assert step == 10
    for a, b in zip(_leaves(p), _leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(opt2["step"]) == 7


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    p = _params()
    opt = {"step": np.int32(0)}
    for s in (10, 20, 30):
        ck.save(p, opt, s)
    assert ck.latest_step == 30
    assert sorted(ck._list_steps()) == [20, 30]


def test_checkpoint_atomicity_tmp_ignored(tmp_path):
    """A leftover .tmp dir from a crashed save must not be restorable."""
    ck = Checkpointer(str(tmp_path))
    p = _params()
    opt = {"step": np.int32(0)}
    ck.save(p, opt, 5)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ck.latest_step == 5


def test_checkpoint_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    p = _params()
    opt = {"step": np.int32(0)}
    d = ck.save(p, opt, 3)
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(d, victim))
    np.save(os.path.join(d, victim), arr + 1)
    with pytest.raises(IOError):
        ck.restore(3, p, opt)


# ---------------------------------------------------------------------------
# twins of tests/test_fault_domains.py::TestStoreCorruption
# ---------------------------------------------------------------------------

class TestStoreCorruption:
    def test_restore_latest_skips_corrupt_leaf(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        p1 = {"w": np.arange(8.0)}
        p2 = {"w": np.arange(8.0) * 3}
        ck.save(p1, {}, 1)
        d2 = ck.save(p2, {}, 2)
        victim = [f for f in os.listdir(d2) if f.endswith(".npy")][0]
        arr = np.load(os.path.join(d2, victim))
        np.save(os.path.join(d2, victim), arr + 1)   # flip the bits
        got = ck.restore_latest({"w": np.zeros(0)}, {})
        assert got is not None and got[2] == 1       # fell back to step 1
        np.testing.assert_array_equal(np.asarray(got[0]["w"]), p1["w"])

    def test_restore_latest_skips_unreadable_manifest(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save({"w": np.ones(3)}, {}, 5)
        ck.save({"w": np.ones(3) * 2}, {}, 6)
        with open(os.path.join(str(tmp_path), "step_00000006",
                               "manifest.json"), "w") as f:
            f.write("{not json")
        got = ck.restore_latest({"w": np.zeros(0)}, {})
        assert got[2] == 5

    def test_restore_latest_none_when_all_corrupt(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        d = ck.save({"w": np.ones(3)}, {}, 1)
        with open(os.path.join(d, "manifest.json"), "w") as f:
            f.write("{")
        assert ck.restore_latest({"w": np.zeros(0)}, {}) is None

    def test_save_sweeps_orphaned_tmp_dirs(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        os.makedirs(os.path.join(str(tmp_path), "step_00000042.tmp"))
        ck.save({"w": np.ones(2)}, {}, 1)
        leftovers = [d for d in os.listdir(str(tmp_path))
                     if d.endswith(".tmp")]
        assert leftovers == []


# ---------------------------------------------------------------------------
# the same files as the reference's
# ---------------------------------------------------------------------------

TREES = {
    "nested_dict": lambda: (_params(), {"step": np.int32(7)}),
    "lists_and_tuples": lambda: (
        {"layers": [np.arange(3.0), (np.ones((2, 2)), np.int64(4))]},
        {"mu": [np.zeros(3)], "b": None}),
    "none_and_empty": lambda: ({"a": None, "z": np.arange(4, dtype=np.int8),
                                "e": {}}, None),
    "scalars_0d": lambda: ({"x": np.float64(2.5)}, {"step": 7}),
    "int_keys_sorted": lambda: ({3: np.ones(2), 1: np.zeros(2),
                                 2: [np.arange(2)]}, {}),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_leaf_keys_and_files_match_reference(tmp_path, name):
    """The flattener gives ``tree_flatten_with_path``'s keys in its order,
    and a save writes the reference's files byte for byte (manifest
    included); a restore gives back each leaf."""
    params, opt = TREES[name]()
    for tree in (params, opt):
        assert list(tck._flatten_with_paths(tree)) == list(
            jck._flatten_with_paths(tree))
    dj = jck.Checkpointer(str(tmp_path / "jax")).save(params, opt, 4)
    dt = Checkpointer(str(tmp_path / "torch")).save(params, opt, 4)
    assert os.path.basename(dj) == os.path.basename(dt) == "step_00000004"
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    for f in os.listdir(dj):
        with open(os.path.join(dj, f), "rb") as a, \
                open(os.path.join(dt, f), "rb") as b:
            assert a.read() == b.read(), f
    p2, o2, step = Checkpointer(str(tmp_path / "jax")).restore(4, params,
                                                               opt)
    assert step == 4
    for a, b in zip(_leaves((params, opt)), _leaves((p2, o2))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_torch_leaves_save_like_numpy(tmp_path):
    """A tensor leaf (on the CPU here) is saved as its numpy array."""
    t = {"r": torch.arange(6, dtype=torch.float64).reshape(2, 3)}
    n = {"r": np.arange(6, dtype=np.float64).reshape(2, 3)}
    da = Checkpointer(str(tmp_path / "a")).save(t, {}, 1)
    db = Checkpointer(str(tmp_path / "b")).save(n, {}, 1)
    for f in os.listdir(da):
        with open(os.path.join(da, f), "rb") as a, \
                open(os.path.join(db, f), "rb") as b:
            assert a.read() == b.read(), f


def test_restore_onto_device_and_shardings_refused(tmp_path):
    ck = Checkpointer(str(tmp_path))
    p = _params()
    ck.save(p, {"step": np.int32(3)}, 2)
    p2, o2, _ = ck.restore(2, p, {"step": 0}, device="cpu")
    assert isinstance(p2["nested"]["b"], torch.Tensor)
    assert p2["nested"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(p2["w"].numpy(), p["w"])
    assert int(o2["step"]) == 3
    got = ck.restore_latest(p, {"step": 0}, device="cpu")
    assert got[2] == 2 and isinstance(got[0]["w"], torch.Tensor)
    with pytest.raises(NotImplementedError, match="A 14"):
        ck.restore(2, p, {"step": 0}, shardings=({}, {}))
    with pytest.raises(ValueError, match="template"):
        ck.restore_latest()


# ---------------------------------------------------------------------------
# the WAL: framing byte for byte, readers, compaction
# ---------------------------------------------------------------------------

def _batch(rng, nd, ni, n=1000):
    return (rng.integers(0, n, (nd, 2)).astype(np.int64),
            rng.integers(0, n, (ni, 2)).astype(np.int64))


@pytest.mark.parametrize("variant", tck.WAL_VARIANTS)
@pytest.mark.parametrize("sizes", [(0, 0), (3, 0), (0, 5), (7, 11)])
def test_wal_frame_bytes_match_reference(variant, sizes):
    assert tck.WAL_VARIANTS == jck.WAL_VARIANTS
    rng = np.random.default_rng(sum(sizes))
    dels, ins = _batch(rng, *sizes)
    for b in (1, 2 ** 40 + 3):
        assert (tck.SessionStore._encode_record(b, variant, dels, ins)
                == jck.SessionStore._encode_record(b, variant, dels, ins))


def _write_log(store, rng, k=5):
    out = []
    for i in range(1, k + 1):
        dels, ins = _batch(rng, i, 2 * i)
        var = tck.WAL_VARIANTS[i % 4]
        store.append_wal(batch_index=i, variant=var, deletions=dels,
                         insertions=ins)
        out.append((i, var, dels, ins))
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_written_by_one_package_reads_in_the_other(tmp_path, writer):
    stores = {"jax": jck.SessionStore(str(tmp_path / "j")),
              "torch": SessionStore(str(tmp_path / "t"))}
    logged = _write_log(stores["jax"], np.random.default_rng(5))
    _write_log(stores["torch"], np.random.default_rng(5))
    with open(stores["jax"].wal_path, "rb") as a, \
            open(stores["torch"].wal_path, "rb") as b:
        assert a.read() == b.read()
    reader = stores["torch" if writer == "jax" else "jax"]
    reader.wal_path = stores[writer].wal_path
    recs = reader.read_wal()
    assert [r.batch_index for r in recs] == [1, 2, 3, 4, 5]
    for r, (i, var, dels, ins) in zip(recs, logged):
        assert r.variant == var
        np.testing.assert_array_equal(r.deletions, dels)
        np.testing.assert_array_equal(r.insertions, ins)
    assert [r.batch_index for r in reader.read_wal(after=3)] == [4, 5]


@pytest.mark.parametrize("damage", ["truncate", "crc", "magic", "variant"])
def test_read_wal_accepts_only_the_valid_prefix(tmp_path, damage):
    """A torn or corrupt frame ends the scan cleanly: the records before it
    are the durable state (the same prefix in both packages)."""
    store = SessionStore(str(tmp_path / "t"))
    _write_log(store, np.random.default_rng(1), k=3)
    sizes = [len(tck.SessionStore._encode_record(
        r.batch_index, r.variant, r.deletions, r.insertions))
        for r in store.read_wal()]
    third = sizes[0] + sizes[1]
    with open(store.wal_path, "rb+") as f:
        if damage == "truncate":
            f.truncate(third + sizes[2] - 11)
        elif damage == "crc":
            f.seek(third + 8)
            f.write(b"\xff\xff\xff\xff")
        elif damage == "magic":
            f.seek(third)
            f.write(b"XX")
        else:
            # a variant code past the table, with its crc made right
            f.seek(third)
            body = bytearray(f.read()[12:])
            body[8] = 9
            f.seek(third + 8)
            f.write((zlib.crc32(bytes(body)) & 0xFFFFFFFF).to_bytes(4,
                                                                    "little"))
            f.write(bytes(body))
    assert store.wal_tip() == 2
    jstore = jck.SessionStore(str(tmp_path / "t"))
    assert [r.batch_index for r in jstore.read_wal()] == [1, 2]


def test_truncate_compact_and_tip(tmp_path):
    store = SessionStore(str(tmp_path / "s"))
    assert store.wal_tip() == -1 and store.wal_size() == 0
    store.truncate_wal(0)                      # no log yet: a no-op
    store.compact_wal(keep_after=0)
    assert not os.path.exists(store.wal_path)
    rng = np.random.default_rng(2)
    _write_log(store, rng, k=2)
    size2 = store.wal_size()
    dels, ins = _batch(rng, 1, 1)
    store.append_wal(batch_index=3, variant="df", deletions=dels,
                     insertions=ins)
    assert store.wal_tip() == 3
    store.truncate_wal(size2)
    assert store.wal_tip() == 2 and store.wal_size() == size2
    store.compact_wal(keep_after=1)
    assert [r.batch_index for r in store.read_wal()] == [2]
    assert not os.path.exists(store.wal_path + ".tmp")


def test_checkpoint_compacts_to_oldest_retained_step(tmp_path):
    """``checkpoint`` keeps the WAL records after the OLDEST retained
    checkpoint; the store's files equal the reference's for the same
    history."""
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 50, (40, 2)).astype(np.int64)
    stores = (SessionStore(str(tmp_path / "t"), keep=2),
              jck.SessionStore(str(tmp_path / "j"), keep=2))
    for store in stores:
        r = np.random.default_rng(9)
        for b in range(1, 8):
            dels, ins = _batch(r, 1, 2, n=50)
            store.append_wal(batch_index=b, variant="df", deletions=dels,
                             insertions=ins)
            if b % 3 == 0:
                store.checkpoint(ranks=np.full(50, b / 50.0), edges=edges,
                                 batch_index=b)
        store.write_meta({"n": 50, "kind": "test"})
    ts, js = stores
    assert sorted(ts.ckpt._list_steps()) == [3, 6]
    assert [r.batch_index for r in ts.read_wal()] == [4, 5, 6, 7]
    assert ts.latest_checkpoint_index == 6
    state, idx = ts.restore_latest_state()
    assert idx == 6 and state["edges"].dtype == np.int64
    np.testing.assert_array_equal(state["ranks"], np.full(50, 6 / 50.0))
    for rel in ("wal.bin", "meta.json", "ckpt/step_00000006/manifest.json",
                "ckpt/step_00000006/params__edges.npy",
                "ckpt/step_00000006/params__ranks.npy"):
        with open(os.path.join(ts.dir, rel), "rb") as a, \
                open(os.path.join(js.dir, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert ts.read_meta() == {"n": 50, "kind": "test"}
    assert not os.path.exists(os.path.join(ts.dir, "meta.json.tmp"))
    assert SessionStore(str(tmp_path / "empty")).restore_latest_state() \
        is None


def test_wal_record_is_frozen():
    rec = tck.WalRecord(1, "df", np.zeros((0, 2), np.int64),
                        np.zeros((0, 2), np.int64))
    with pytest.raises(Exception):
        rec.batch_index = 2
