"""The port's public import surface (ROADMAP C 9) against the reference's.

``repro_torch.api.__all__`` is ``tests/test_api_surface.py::EXPECTED_API``
minus the names of items not ported yet, each tagged with the ROADMAP item
that brings it, and so are the registered builtin engines and the public
members of the session and the service; the ``EngineConfig`` fields are
the reference's; ``repro_torch.core.__all__`` is ``repro.core.__all__``.
Importing the public surface loads no JAX and nothing of ``repro``, and the
hint of the legacy functions' ``DeprecationWarning`` resolves.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as jcore
import repro_torch.api as tapi
import repro_torch.core as tcore
from repro_torch.api import session as tsession
from repro_torch.core import pagerank as tpr

ROOT = Path(__file__).resolve().parents[1]

# reference names of later slices, by the ROADMAP item that ports them
UNPORTED = {
    "ShardFault": "A 14", "ShardFaultDomain": "A 14",
}
# the reference's builtin engines and public session and service members of
# later slices, tagged the same way (the walk engine, ``ppr_query`` and the
# walk fields came with A 13)
UNPORTED_ENGINES = {"distributed": "A 14"}
UNPORTED_MEMBERS = {"inject_shard_fault": "A 14"}


def _reference_surface():
    spec = importlib.util.spec_from_file_location(
        "_reference_api_surface", ROOT / "tests" / "test_api_surface.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _expected_api() -> set:
    return set(_reference_surface().EXPECTED_API)


def test_engines_fields_and_members_are_the_reference_minus_unported():
    import dataclasses

    from repro.api import PageRankService as JService
    from repro.api import PageRankSession as JSession
    ref = _reference_surface()
    engines = set(ref.EXPECTED_BUILTIN_ENGINES) - set(UNPORTED_ENGINES)
    assert set(tapi.registry.names()) == engines
    assert "walk" in engines
    assert {f.name for f in dataclasses.fields(tapi.EngineConfig)} == \
        set(ref.EXPECTED_CONFIG_FIELDS)
    for jcls, tcls in ((JSession, tapi.PageRankSession),
                       (JService, tapi.PageRankService)):
        names = {n for n in dir(jcls) if not n.startswith("_")}
        missing = {n for n in names if not hasattr(tcls, n)}
        assert missing == set(UNPORTED_MEMBERS) & names, missing
    assert callable(tapi.PageRankSession.ppr_query)
    assert callable(tapi.PageRankService.ppr_query)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for item in {**UNPORTED_ENGINES, **UNPORTED_MEMBERS}.values():
        assert re.search(rf"\*\*{item}: ", roadmap), item


def test_api_all_is_the_reference_minus_unported_items():
    expected = _expected_api()
    assert set(UNPORTED) <= expected
    assert set(tapi.__all__) == expected - set(UNPORTED)
    for name in tapi.__all__:
        assert getattr(tapi, name) is not None, name
    assert tapi.PageRankSession is tsession.PageRankSession
    assert tapi.SweepCapWarning is tsession.SweepCapWarning
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for name, item in UNPORTED.items():
        assert not hasattr(tapi, name), name
        assert re.search(rf"\*\*{item}: ", roadmap), (name, item)


def test_core_all_matches_the_reference():
    assert set(tcore.__all__) == set(jcore.__all__)
    for name in tcore.__all__:       # the stream names resolve lazily
        assert getattr(tcore, name) is not None, name
    from repro_torch.core.stream import StreamRunner
    assert tcore.StreamRunner is StreamRunner
    with pytest.raises(AttributeError):
        tcore.not_a_name


def test_importing_the_public_surface_loads_no_jax():
    code = ("import sys\n"
            "from repro_torch.api import EngineConfig, PageRankSession\n"
            "from repro_torch.core import StreamRunner, run_stream\n"
            "import repro_torch.core.stream as s\n"
            "s.StreamBatchResult, s._seed_affected\n"
            "print(','.join(sorted(m for m in sys.modules\n"
            "                      if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                             'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "", out.stdout


def test_deprecation_hint_resolves():
    with pytest.warns(DeprecationWarning) as rec:
        tpr._deprecated("df_pagerank", "PageRankSession.update")
    msg = str(rec[0].message)
    path = re.search(r"use (repro_torch\.api\.[\w.]+) instead", msg).group(1)
    obj = tapi
    for part in path.split(".")[2:]:
        obj = getattr(obj, part)
    assert obj is tsession.PageRankSession.update
