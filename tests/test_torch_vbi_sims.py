"""The port's host-side VBI and reliability models (``repro_torch/core/
reliability.py``, ``core/vbi/{cvt,transsim,hetero}.py`` and the filled
``core/vbi/__init__.py``) against the JAX package's copies:

  * ``activation_failure_rate`` gives the reference's rate at several
    (rows, variation, node), and ``table_2_3`` the reference's table;
  * protection is decoupled from translation on the port's
    ``ClientVBTable`` over its ``MTL`` (the reference's
    ``tests/test_vbi.py`` case, run on the port);
  * ``run_comparison`` on a small trace, ``amat`` and ``speedup`` equal
    the reference's;
  * ``repro_torch.core.vbi.__all__`` is the reference's, name for name."""
import numpy as np
import pytest

import repro.core.vbi as jvbi
from repro.core import reliability as jrel
from repro.core.vbi import hetero as jhet
from repro.core.vbi import transsim as jts
import repro_torch.core.vbi as tvbi
from repro_torch.core import reliability as trel
from repro_torch.core.vbi import hetero as thet
from repro_torch.core.vbi import transsim as tts
from repro_torch.core.vbi.address_space import SIZE_CLASSES, VBProps
from repro_torch.core.vbi.cvt import ClientVBTable, PermissionError_, RWX
from repro_torch.core.vbi.mtl import MTL, PhysicalMemory


@pytest.mark.parametrize("n_rows,variation,node,b2b", [
    (3, 0.0, 45, 1), (3, 0.1, 32, 2), (5, 0.2, 22, 1), (5, 0.05, 45, 1)])
def test_activation_failure_rate_matches_reference(n_rows, variation, node,
                                                   b2b):
    kw = dict(trials=400, seed=3, back_to_back=b2b)
    assert trel.activation_failure_rate(n_rows, variation, node, **kw) == \
        jrel.activation_failure_rate(n_rows, variation, node, **kw)
    assert trel.NODE_RATIO == jrel.NODE_RATIO
    assert trel.SENSE_OFFSET_SIGMA == jrel.SENSE_OFFSET_SIGMA


def test_table_2_3_matches_reference():
    mine, ref = trel.table_2_3(trials=200), jrel.table_2_3(trials=200)
    assert mine == ref
    # QRA fails first at the smallest node, as in Table 2.3
    assert mine[22]["QRA"][0.2] >= mine[22]["TRA"][0.2]


def test_protection_decoupled_from_translation():
    mtl = MTL(PhysicalMemory(256))
    tbl = ClientVBTable(mtl)
    alice = tbl.new_client(1, "alice")
    bob = tbl.new_client(2, "bob")
    vb = mtl.enable_vb(1, VBProps.READ_ONLY)
    idx_a = tbl.attach(alice, 1, vb, RWX.RW)
    tbl.attach(bob, 1, vb, RWX.R)
    tbl.check_access(alice, idx_a, 0, RWX.W)       # ok
    with pytest.raises(PermissionError_):
        tbl.check_access(bob, 0, 0, RWX.W)         # bob is read-only
    with pytest.raises(PermissionError_):
        tbl.check_access(alice, idx_a, SIZE_CLASSES[1] + 1, RWX.R)
    with pytest.raises(PermissionError_):
        tbl.check_access(alice, 7, 0, RWX.R)       # invalid CVT index
    assert mtl.vit[1][vb].refcount == 2
    tbl.destroy_client(bob)
    assert mtl.vit[1][vb].refcount == 1
    # the CVT cache converges to hits
    for _ in range(50):
        tbl.check_access(alice, idx_a, 64, RWX.R)
    assert tbl.caches[1].hit_rate > 0.9
    assert tbl.vbi_address(alice, idx_a, 64) == \
        jvbi.encode_vbi_addr(1, vb, 64)


def test_translation_simulator_matches_reference():
    kw = dict(n_accesses=4000, working_set_pages=1 << 12, seed=5)
    cfg, jcfg = tts.TraceConfig(**kw), jts.TraceConfig(**kw)
    np.testing.assert_array_equal(tts.synth_trace(cfg),
                                  jts.synth_trace(jcfg))
    mine, ref = tts.run_comparison(cfg), jts.run_comparison(jcfg)
    assert mine == ref
    # the trend the model reproduces: VBI translates less than native
    assert mine["speedup_native"] > 1 and mine["speedup_vm"] > 1
    pages = tts.synth_trace(cfg)
    assert tts.simulate(pages, "vbi", cfg, vb_translation="multi") == \
        jts.simulate(pages, "vbi", jcfg, vb_translation="multi")
    with pytest.raises(ValueError):
        tts.simulate(pages, "bogus", cfg)


@pytest.mark.parametrize("system", ["PCM_DRAM", "TL_DRAM"])
def test_hetero_placement_matches_reference(system):
    mine, ref = getattr(thet, system), getattr(jhet, system)
    heat = thet.page_heat(512, seed=2)
    np.testing.assert_array_equal(heat, jhet.page_heat(512, seed=2))
    for aware in (False, True):
        assert thet.amat(mine, heat, aware) == jhet.amat(ref, heat, aware)
    assert thet.speedup(mine, n_pages=1024, seed=1) == \
        jhet.speedup(ref, n_pages=1024, seed=1)
    assert thet.speedup(mine)["runtime_speedup"] > 1


def test_vbi_exports_match_reference():
    assert tvbi.__all__ == jvbi.__all__
    for name in tvbi.__all__:            # the port's own objects
        mod = getattr(getattr(tvbi, name), "__module__", "repro_torch.")
        assert mod.startswith("repro_torch."), name
