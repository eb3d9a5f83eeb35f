"""The scan kernel's two-level tables (tpujpeg_torch.ops.fsm.scan_table)
against the flat per-peek map and against the JAX package's tables.

`scan_table_lookup` is the kernel's lookup in numpy; it must return, at
every one of the 4 x 65,536 peeks, the entry the flat map
(`symbol_lut`) holds, for the tables of every committed corpus and
golden, for random canonical tables, and what the JAX package's own
two-level symbol map (`tpujpeg.ops.fsm.build_tables`: len_keys, len_vals,
symtab) gives for the same streams.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from tpujpeg.io.parser import parse_file as jax_parse_file
from tpujpeg.ops import fsm as jfsm
from tpujpeg_torch import convert
from tpujpeg_torch.io.huffman import HuffmanTable
from tpujpeg_torch.io.parser import Component, JpegImage
from tpujpeg_torch.ops import fsm as tfsm

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
STREAMS = {
    "444_rst": "rst640/00.jpg",
    "444_photo": "photo640/05.jpg",
    "444_mixed": "mixed_rst/03_784x765.jpg",
    "420_mixed": "mixed_rst_420/02_680x678.jpg",
    "420_rst": "rst640_420/00.jpg",
    "420_photo": "photo640_420/07.jpg",
    "gray": "sampling_small/gray.jpg",
    "411": "sampling_small/411_rst.jpg",
    "422": "sampling_small/422_rst.jpg",
    "440": "sampling_small/440_rst.jpg",
    "golden_1": "1_320x240.jpg",
    "golden_2": "2_400x400.jpg",
    "golden_3": "3_120x120.jpg",
    "golden_4": "4_800x600.jpg",
    "golden_5": "5_200x200.jpg",
    "golden_6": "6_225x168.jpg",
    "golden_8": "8_401x363.jpg",
}
TBL = np.repeat(np.arange(tfsm.N_TABLES), 1 << 16)
PEEK = np.tile(np.arange(1 << 16), tfsm.N_TABLES)


def _check_against_flat_map(tables):
    """The table's plain lookup == symbol_lut at every peek; returns the
    looked-up (length, symbol)."""
    table = tfsm.scan_table(tables)
    assert table.dtype == np.int32 and table.ndim == 1
    n_sub, rest = divmod(table.size - (tfsm.N_TABLES << tfsm.SCAN_L1_BITS), 64)
    assert rest == 0 and 0 <= n_sub <= tfsm.SCAN_SUB_MAX
    entry = tfsm.scan_table_lookup(table, TBL, PEEK)
    lut = tfsm.symbol_lut(tables).reshape(-1).astype(np.int64)
    np.testing.assert_array_equal(entry & 0x1FFF, lut)
    length, sym = lut >> 8, lut & 0xFF
    # the packed third field: length + size under a valid length
    np.testing.assert_array_equal(
        entry >> 13, np.where(length <= 16, length + (sym & 15), 0))
    return length, sym


@pytest.mark.parametrize("name", list(STREAMS))
def test_scan_table_equals_flat_map_and_jax_tables(name):
    jimg = jax_parse_file(os.path.join(FIXTURES, STREAMS[name]))
    tables = tfsm.build_tables(convert.image_from_jax(jimg))
    length, sym = _check_against_flat_map(tables)
    # the JAX package's own lookup at the same peeks: the last
    # (table, length) key <= the peek gives the length and the offset into
    # the global symbol grid
    jt = jfsm.build_tables(jimg)
    assert convert.tables_from_jax(jt) == tables
    assert jt.symtab is not None
    keys = np.asarray(jt.len_keys, np.int64)
    vals = np.asarray(jt.len_vals, np.int64)
    grid = np.asarray(jt.symtab, np.int64).reshape(-1)
    present = sorted({int(k) >> 16 for k in keys})
    assert present == sorted({s + 2 * ac for s in set(tables.tsel)
                              for ac in (0, 1)})
    for tbl in present:
        q = (tbl << 16) | np.arange(1 << 16, dtype=np.int64)
        packed = vals[np.searchsorted(keys, q, side="right") - 1]
        jlen = packed >> 18
        adj = (packed & 0x3FFFF) - 0x20000
        code = (q & 0xFFFF) >> np.clip(16 - jlen, 0, 16)
        jsym = np.where(jlen <= 16, grid[np.where(jlen <= 16, code + adj, 0)],
                        0)
        mine = slice(tbl << 16, (tbl + 1) << 16)
        np.testing.assert_array_equal(length[mine], jlen)
        np.testing.assert_array_equal(sym[mine], jsym)


def _image(dc0, ac0, dc1, ac1) -> JpegImage:
    """A three-component image on two table sets (only the tables and
    the components matter to build_tables)."""
    return JpegImage(
        width=16, height=16, precision=8,
        components=[Component(1, 1, 1, 0, 0, 0), Component(2, 1, 1, 1, 1, 1),
                    Component(3, 1, 1, 1, 1, 1)],
        quant_tables={}, huffman={0x00: dc0, 0x10: ac0, 0x01: dc1, 0x11: ac1},
        restart_interval=0, scan_data=np.zeros(0, np.uint8),
        segment_offsets=np.zeros(1, np.int64),
    )


def _table(lengths, alphabet) -> HuffmanTable:
    """A canonical table with these code lengths over the first symbols
    of `alphabet` (shuffling is the caller's)."""
    lengths = sorted(lengths)
    counts = np.bincount(lengths, minlength=17)[1:17]
    return HuffmanTable(counts, np.asarray(alphabet[: len(lengths)], np.uint8))


DC_SYMBOLS = list(range(12))
AC_SYMBOLS = [r << 4 | s for r in range(16) for s in range(11)]


@st.composite
def code_lengths(draw, max_codes: int):
    """Code lengths of a full prefix code (split a leaf until there are
    enough), optionally with its last, all-ones code dropped."""
    n = draw(st.integers(2, max_codes))
    lengths = [1, 1]
    while len(lengths) < n:
        open_ = [i for i, x in enumerate(lengths) if x < 16]
        i = open_[draw(st.integers(0, len(open_) - 1))]
        lengths[i] += 1
        lengths.append(lengths[i])
    if draw(st.booleans()):
        lengths.remove(max(lengths))
    return lengths


@st.composite
def table_sets(draw):
    out = []
    for alphabet, cap in ((DC_SYMBOLS, 12), (AC_SYMBOLS, 176)) * 2:
        symbols = draw(st.permutations(alphabet))
        out.append(_table(draw(code_lengths(cap)), symbols))
    return out


@settings(max_examples=30, deadline=None)
@given(table_sets())
def test_scan_table_equals_flat_map_on_random_canonical_tables(tabs):
    tables = tfsm._build_tables_uncached(_image(*tabs))
    length, _ = _check_against_flat_map(tables)
    assert (length <= 16).any()


@pytest.mark.parametrize("full", [True, False])
def test_scan_table_with_sixteen_bit_codes(full):
    # lengths 1, 2, .., 15, 16, 16 fill the code space and end in the
    # all-ones 16-bit code; without that last code the top peek is invalid
    chain = list(range(1, 17)) + ([16] if full else [])
    dc_chain = list(range(1, 12)) + ([11] if full else [])
    tabs = [_table(dc_chain, DC_SYMBOLS), _table(chain, AC_SYMBOLS),
            _table(dc_chain, DC_SYMBOLS[::-1]), _table(chain, AC_SYMBOLS[::-1])]
    tables = tfsm._build_tables_uncached(_image(*tabs))
    length, sym = _check_against_flat_map(tables)
    ac = slice(2 << 16, 3 << 16)
    assert length[ac][0xFFFE] == 16
    assert length[ac][0xFFFF] == (16 if full else tfsm.INVALID_LEN)
    assert (length == tfsm.INVALID_LEN).any() != full
    # 16-bit codes differ in their last bit: their peeks cannot share a
    # first-level entry
    table = tfsm.scan_table(tables)
    assert table[(2 << 10) | 0x3FF] < 0


def test_scan_table_marks_an_unselected_plane_it_cannot_hold():
    # a table set that no block selects (a grayscale image has one) takes
    # the flat map's filler; here that filler is the previous table's last
    # piece, a long code stretched over the whole plane, which no 64-entry
    # second level can hold: those planes are marked invalid, the selected
    # ones stay exact
    chain = list(range(1, 17)) + [16]
    dc_chain = list(range(1, 12)) + [11]
    img = _image(_table(dc_chain, DC_SYMBOLS), _table(chain, AC_SYMBOLS),
                 _table(dc_chain, DC_SYMBOLS), _table(chain, AC_SYMBOLS))
    img.components = img.components[:1]
    tables = tfsm._build_tables_uncached(img)
    assert set(tables.tsel) == {0}
    entry = tfsm.scan_table_lookup(tfsm.scan_table(tables), TBL, PEEK)
    lut = tfsm.symbol_lut(tables).reshape(-1)
    for tbl in range(tfsm.N_TABLES):
        mine = slice(tbl << 16, (tbl + 1) << 16)
        if tbl % 2 == 0:
            np.testing.assert_array_equal(entry[mine] & 0x1FFF, lut[mine])
        else:
            assert (lut[mine] >> 8 <= 16).all()     # the filler is a code
            assert (entry[mine] == tfsm.INVALID_LEN << 8).all()
