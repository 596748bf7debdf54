"""The port's threefry (``repro_torch.core.threefry``) against ``jax.random``:
keys, ``fold_in`` and the ``uniform`` draws the walk engine takes, equal
bit for bit.

The JAX side sets ``jax_threefry_partitionable=True`` itself (JAX's
default since 0.5, which the port reproduces), so a change of JAX's
default shows here as a failure rather than as a silent difference in the
walk parity tests.  ``uniform`` is checked in f32 and in f64: the
reference's walks draw in JAX's default float, f64 under
``jax_enable_x64`` (``tests/conftest.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import threefry

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 + 5]
WIDS = [0, 1, 12345, 2 ** 31 - 2]
LENGTHS = [2, 16, 48]


@pytest.fixture(autouse=True)
def _partitionable():
    """Pin the counter layout the port reproduces, and one intra-op
    thread per test (see tests/test_torch_push.py)."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.config.update("jax_threefry_partitionable", old)


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("wid", WIDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_draws_equal_jax_random(seed, wid, L):
    jkey = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    assert np.array_equal(_words(jkey), np.array(tkey))
    jw = jax.random.fold_in(jkey, wid)
    tw = threefry.fold_in(tkey, wid)
    assert np.array_equal(_words(jw), np.array(tw))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        ju = np.asarray(jax.random.uniform(jw, (2, L), dtype=jdt))
        tu = threefry.uniform(tw, (2, L), dtype=tdt).numpy()
        assert ju.dtype == tu.dtype
        assert np.array_equal(ju, tu), (seed, wid, L, jdt)
    # the walk engine's own call: jax.random.uniform at the default dtype
    ju = np.asarray(jax.random.uniform(jw, (2, L)))
    assert ju.dtype == np.float64
    assert np.array_equal(ju, threefry.uniform(tw, (2, L),
                                               dtype=torch.float64).numpy())
    jb = np.asarray(jax.random.bits(jw, (2, L), dtype=jnp.uint32))
    jb = jb.astype(np.int64)
    assert np.array_equal(jb, threefry.uniform_bits(tw, (2, L)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_vectorised_keys_equal_one_at_a_time(seed):
    """One tensor of walk ids gives each id's ``fold_in`` key and draws, as
    the walk engine's plain version takes them."""
    jkey = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    wids = torch.tensor(WIDS + [7, 99])
    k0, k1 = threefry.fold_in(tkey, wids)
    u = threefry.uniform((k0, k1), (2, 16), dtype=torch.float64).numpy()
    b32 = threefry.uniform_bits((k0, k1), (2, 16)).numpy()
    for i, w in enumerate(wids.tolist()):
        jw = jax.random.fold_in(jkey, w)
        assert np.array_equal(_words(jw), [int(k0[i]), int(k1[i])])
        assert np.array_equal(np.asarray(jax.random.uniform(jw, (2, 16))),
                              u[i])
        jb = np.asarray(jax.random.bits(jw, (2, 16), dtype=jnp.uint32))
        assert np.array_equal(jb.astype(np.int64), b32[i])


def test_key_and_dtype_errors():
    with pytest.raises(ValueError, match="outside"):
        threefry.prng_key(-1)
    with pytest.raises(ValueError, match="outside"):
        threefry.prng_key(1 << 64)
    with pytest.raises(ValueError, match="dtype"):
        threefry.uniform((0, 0), (2,), dtype=torch.float16)
