"""The SSE tables' compact form, which the CUDA tracer's parity instances
keep in shared memory in place of the 48 KB tables (8 KB): every entry
of the host's dump is 0x3F000000 | (12 bits << 11), rsqrt entries repeat
in aligned groups of 4 and rcp entries in groups of 2
(`core.approx.compact_tables`).  The kernel rebuilds an entry as
0x3F000000 | (e << 11) (csrc/tracer_body.cuh rsq_emu, rcp_emu); these
tests restate that rebuild in numpy and hold it to the repo's dump, and
check that a dump without that structure is refused before any launch.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pwnfps_tpu_torch import scene as S
from pwnfps_tpu_torch.core.approx import (COMPACT_RCP, COMPACT_RSQ,
                                          SseTables, compact_tables)
from pwnfps_tpu_torch.ops import tracer
from pwnfps_tpu_torch.ops.world import world_to_torch


@pytest.fixture(scope="module")
def tables():
    return SseTables.load()


def _rebuild(compact: np.ndarray):
    """The kernel's lookups, restated: rsqrt index p * 4096 + i reads
    R[p * 1024 + (i >> 2)], rcp index i reads C[i >> 1]."""
    c = compact.astype(np.uint32)
    i = np.arange(8192)
    rsq = 0x3F000000 | (c[(i >> 12) * 1024 + ((i & 4095) >> 2)] << 11)
    j = np.arange(4096)
    rcp = 0x3F000000 | (c[COMPACT_RSQ + (j >> 1)] << 11)
    return rsq.astype(np.uint32), rcp.astype(np.uint32)


def test_compact_tables_rebuild_every_entry(tables):
    compact = compact_tables(tables.rsqrt, tables.rcp)
    assert compact.shape == (COMPACT_RSQ + COMPACT_RCP,)
    assert compact.dtype == np.uint16 and compact.max() < 4096
    rsq, rcp = _rebuild(compact)
    np.testing.assert_array_equal(rsq, tables.rsqrt)
    np.testing.assert_array_equal(rcp, tables.rcp)


# (table, index, how the entry is broken)
BROKEN = {
    "rsqrt_low_bit": ("rsqrt", 4097, lambda v: v | 1),
    "rcp_low_bit": ("rcp", 17, lambda v: v | 0x400),
    "rsqrt_exponent": ("rsqrt", 0, lambda v: v + (1 << 23)),
    "rcp_sign": ("rcp", 4095, lambda v: v | 0x80000000),
    "rsqrt_group": ("rsqrt", 4 * 300 + 3, lambda v: v ^ (1 << 11)),
    "rcp_group": ("rcp", 2 * 700 + 1, lambda v: v ^ (1 << 22)),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_dump_raises(tables, case):
    which, i, breaks = BROKEN[case]
    tabs = {"rsqrt": tables.rsqrt.copy(), "rcp": tables.rcp.copy()}
    tabs[which][i] = breaks(tabs[which][i])
    with pytest.raises(ValueError):
        compact_tables(tabs["rsqrt"], tabs["rcp"])


def test_wrong_shape_raises(tables):
    with pytest.raises(ValueError):
        compact_tables(tables.rsqrt[:4096], tables.rcp)


def _parity_world(kind: str):
    if kind == "one_page":
        return S.parity_scene(8, 8, "cpu")
    return S.maze_scene(8, 8, "cpu", parity=True)


@pytest.mark.parametrize("kind", ["one_page", "paged"])
def test_world_carries_compact_tables(tables, kind):
    sc = _parity_world(kind)
    wt = sc.tworld
    assert wt.n_pages == (1 if kind == "one_page" else 4)
    want = compact_tables(np.asarray(sc.world.rsqrt_tab),
                          np.asarray(sc.world.rcp_tab))
    assert wt.sse.dtype == torch.int16 and wt.sse.shape == (4096,)
    np.testing.assert_array_equal(wt.sse.numpy().view(np.uint16), want)
    np.testing.assert_array_equal(want, compact_tables(tables.rsqrt,
                                                       tables.rcp))
    # the plain tracer keeps the full tables
    np.testing.assert_array_equal(wt.rsqrt_tab.numpy().view(np.uint32),
                                  tables.rsqrt)
    # the kernel's argument is the compact table's address, last of the
    # world's six
    index, addrs = tracer._world_args(wt)
    assert index == -1 and len(addrs) == 6
    assert addrs[-1] == wt.sse.data_ptr()


def test_world_to_torch_refuses_tables_that_do_not_compact():
    sc = _parity_world("one_page")
    bad = np.asarray(sc.world.rcp_tab).copy()
    bad[5] |= 1
    with pytest.raises(ValueError, match="rcp"):
        world_to_torch(sc.world._replace(rcp_tab=bad), sc.meta, "cpu")
