"""The multi-index-hashing index: per-table entry arrays on the device.

Port of ``verticut_tpu/index/mih.py``. Per table, one stable sort of the
substrings orders the entries by ``(substring, id)``, and a directory maps
substring values to entry rows:

* the range engine (``directory="range"``, and ``"auto"`` for substrings
  wider than ``dense_threshold`` bits): a range directory over substring
  prefixes, the entries in one of two blocked layouts:

  - inline (``store_codes=True``): word-major ``(id, code)`` rows,
    ``entry_block_size(W)`` entries per row (25 at W = 4), so one gathered
    row scores a whole block;
  - compact (``store_codes=False``): id-only rows of :data:`ID_ROW_BLOCK`
    ids; candidate codes are gathered from the shared id-ordered
    ``codes``;

* the bucket engines (``"dense"``, which ``"auto"`` picks up to
  ``dense_threshold`` bits, ``"sorted"``, ``"prefix"``, ``"hash"``): the
  flat sorted ids, per-entry code copies (``entry_codes``) with
  ``store_codes``, and a bucket directory; ``with_bitmap`` adds an
  occupancy bitmap per table.

``keep_entry_ids=False`` drops a range table's flat id column (the blocked
rows hold the ids as well), as the reference drops it above 20M codes.
:func:`save_index` and :func:`load_index` read and write the reference's
``.npz`` keys for every table kind, so a file written by either package
loads in the other.

The reference also keeps ``codes_t`` (a transposed scan copy) and
``codes_rows`` (blocked rescore rows), and can build a TPU scan copy
(``scan_copy``). All work around TPU memory layouts: Mosaic's (8, 128)
tiling of a ``[N, 4]`` operand and the TPU's per-row gather cost. The port
scans and rescores off the row-major ``codes`` array, the natural operand
of a GPU kernel, so it has none of them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from verticut_tpu_torch import bits as bits_lib
from verticut_tpu_torch import codes as codes_lib
from verticut_tpu_torch.config import MIHConfig
from verticut_tpu_torch.index import directory as dir_lib
from verticut_tpu_torch.index.bitmap import Bitmap, build_bitmap

#: ids per compact-layout row (128 B), and the id-count alignment (4 rows)
ID_ROW_BLOCK = 32
ID_ROW_ALIGN = 128

#: entries assembled at a time into the inline rows: bounds the build's
#: gathered-code temporaries (~0.3 GB at W = 4) at any corpus size
ASSEMBLY_CHUNK = 4 * 1024 * 1024


class MIHTable(NamedTuple):
    """One substring hash table."""

    entry_ids: Optional[torch.Tensor]  # int32[N] ids in substring order
    directory: dir_lib.Directory
    # inline layout: int32[NB, blk*RW], one row = one blk-entry block
    # stored word-major (lane w*blk + r = word w of entry r; word 0 = id,
    # words 1..W = code; pad entries carry id -1 and a zero code)
    entry_rows: Optional[torch.Tensor] = None
    # compact layout: int32[NBc, ID_ROW_BLOCK] ids, pad id -1
    entry_idrows: Optional[torch.Tensor] = None
    # bucket tables: int32[N, W] codes in substring order, or None (then
    # candidate codes come from the index's codes)
    entry_codes: Optional[torch.Tensor] = None
    bitmap: Optional[Bitmap] = None           # bucket occupancy

    def n_entries(self, n_words: int) -> int:
        """Entry count (the padded count of the blocked rows when the flat
        ids are absent)."""
        if self.entry_ids is not None:
            return self.entry_ids.shape[0]
        if self.entry_idrows is not None:
            return self.entry_idrows.numel()
        blk = entry_block_size(n_words)
        lanes = self.entry_rows.shape[1]
        if blk * _row_width(n_words) != lanes:
            raise ValueError(
                f"entry-row lane count {lanes} does not match n_words="
                f"{n_words} (expected {blk * _row_width(n_words)})")
        return self.entry_rows.shape[0] * blk


def _row_width(n_words: int) -> int:
    """Words per entry: 1 id word + the code words, no padding."""
    return 1 + n_words


def entry_block_size(n_words: int) -> int:
    """Entries per fetch block: the largest blk with blk * row width <= 128
    words (one row <= 512 B)."""
    return 128 // _row_width(n_words)


def entry_row_align(n_words: int) -> int:
    """Entry-count alignment of the blocked layout: whole blocks, x8."""
    return entry_block_size(n_words) * 8


@dataclasses.dataclass
class MIHIndex:
    """m per-substring tables plus the id-ordered codes, all on one device."""

    cfg: MIHConfig
    tables: List[MIHTable]
    n: int                              # number of indexed codes
    codes: Optional[torch.Tensor]       # int32[N, W], row i = id i

    @property
    def device(self) -> torch.device:
        t = self.tables[0]
        return next(x.device for x in (t.entry_ids, t.entry_rows,
                                       t.entry_idrows) if x is not None)

    @property
    def is_range(self) -> bool:
        """Whether the tables are range tables (else bucket tables)."""
        return isinstance(self.tables[0].directory, dir_lib.RangeDirectory)

    @property
    def compact(self) -> bool:
        """Whether the tables hold id-only rows (codes gathered from
        ``codes``)."""
        t = self.tables[0]
        return t.entry_rows is None and t.entry_idrows is not None

    def fetch_block(self) -> int:
        """Entries per fetched row of the tables' layout (for bucket
        tables, the chunk width of the strip selection, as in the
        reference)."""
        return (ID_ROW_BLOCK if self.compact
                else entry_block_size(self.cfg.n_words))

    def table_subs(self, queries: torch.Tensor) -> torch.Tensor:
        """Substring values of a query batch for every table: [Q, m]."""
        return codes_lib.all_substrings(queries, self.cfg.n_tables)


def _padded_ids(sorted_ids: torch.Tensor, npad: int) -> torch.Tensor:
    out = torch.full((npad,), -1, dtype=torch.int32, device=sorted_ids.device)
    out[:sorted_ids.shape[0]] = sorted_ids
    return out


def make_entry_idrows(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Compact-layout rows: the ids padded with -1 to a multiple of
    :data:`ID_ROW_ALIGN`, :data:`ID_ROW_BLOCK` per row."""
    n = sorted_ids.shape[0]
    npad = -(-max(n, 1) // ID_ROW_ALIGN) * ID_ROW_ALIGN
    return _padded_ids(sorted_ids, npad).reshape(-1, ID_ROW_BLOCK)


def make_entry_rows(sorted_ids: torch.Tensor, codes: torch.Tensor
                    ) -> torch.Tensor:
    """Blocked word-major ``(id, code)`` rows, padded as the JAX package's
    native build pads them (``index/build_native._host_entry_rows``):
    entries to a multiple of ``entry_row_align(W)``, pad ids -1. Assembled
    :data:`ASSEMBLY_CHUNK` entries at a time into the output, so no
    ``[Npad, RW]`` copy of the table exists besides the rows themselves."""
    n, w = codes.shape
    rw = _row_width(w)
    blk = entry_block_size(w)
    align = entry_row_align(w)
    npad = -(-max(n, 1) // align) * align
    ids = _padded_ids(sorted_ids, npad)
    out = torch.empty((npad // blk, blk * rw), dtype=torch.int32,
                      device=codes.device)
    ch = ASSEMBLY_CHUNK // blk * blk
    for c0 in range(0, npad, ch):
        idc = ids[c0:c0 + ch]
        g = codes[idc.clamp(min=0).long()]
        g[idc < 0] = 0
        rows = torch.cat([idc[:, None], g], dim=1)          # [ch, rw]
        out[c0 // blk:(c0 + idc.shape[0]) // blk] = rows.reshape(
            -1, blk, rw).transpose(1, 2).reshape(-1, blk * rw)
    return out


def sort_table(codes: torch.Tensor, table_id: int, s_bits: int):
    """One table's ``(sorted substrings, sorted ids)``: a stable sort of
    the substring column, whose id order within equal substrings is the
    corpus order (the reference's ``(substring, id)`` sort). Substrings are
    int32 bit patterns; flipping the sign bit makes their signed order the
    unsigned one. Returns int32 bit patterns and int32 ids.

    The sort's transients are what bound a build's peak memory (at 1B
    codes the key column is 4 GB and the sort's int64 indices 8 GB), so
    each temporary is dropped or narrowed as soon as it is done with."""
    keys = codes_lib.substring(codes, table_id, s_bits) ^ dir_lib.SIGN
    keys, order = torch.sort(keys, stable=True)
    order = order.to(torch.int32)
    return keys.bitwise_xor_(dir_lib.SIGN), order


DIRECTORIES = ("auto", "dense", "sorted", "prefix", "hash", "range")


def _make_directory(sorted_subs: torch.Tensor, s_bits: int, directory: str,
                    range_pbits: int) -> dir_lib.Directory:
    if directory == "dense":
        return dir_lib.build_dense(sorted_subs, s_bits)
    if directory == "prefix":
        return dir_lib.build_prefix(sorted_subs, s_bits)
    if directory == "sorted":
        return dir_lib.build_sorted(sorted_subs)
    if directory == "hash":
        return dir_lib.build_hash(sorted_subs)
    return dir_lib.build_range(sorted_subs, s_bits, pbits=range_pbits)


def build_index(codes_arr, cfg: MIHConfig = MIHConfig(),
                dense_threshold: int = 24, store_codes: bool = True,
                with_bitmap: bool = False, keep_codes: bool = True,
                directory: str = "auto", keep_entry_ids: bool = True, *,
                device=None) -> MIHIndex:
    """Build the m-table index on ``device``: by default the card for numpy
    codes (raising where there is none) and the tensor's own device for a
    tensor. The arguments and defaults are the reference's.

    ``codes_arr``: ``uint32[N, W]`` numpy codes or an ``int32[N, W]``
    tensor; row i is id i. ``directory``: ``auto`` (dense for substrings
    of at most ``dense_threshold`` bits, else range), ``dense``,
    ``sorted``, ``prefix``, ``hash`` or ``range``. ``store_codes`` keeps
    the codes in the tables (a range table's inline rows, a bucket table's
    ``entry_codes``); without it candidate codes come from the kept
    codes. ``with_bitmap`` adds each table's occupancy bitmap;
    ``keep_entry_ids`` keeps a range table's flat id column (a bucket
    table and a table with a bitmap always keep it, as in the reference);
    ``keep_codes`` keeps ``codes`` for the scan tier and the linear
    fallback. Range rows are padded as the JAX package's native build pads
    them; its device build pads alike up to 5M codes and in 5M-entry
    chunks above."""
    if directory not in DIRECTORIES:
        raise ValueError(f"unknown directory kind {directory!r}")
    if not (store_codes or keep_codes):
        raise ValueError("without store_codes (the compact layout) the "
                         "tables gather candidate codes from the kept codes")
    codes = bits_lib.as_codes(
        codes_arr, bits_lib.entry_device(device, codes_arr)).contiguous()
    if codes.ndim != 2 or codes.shape[-1] != cfg.n_words:
        raise ValueError(
            f"codes have shape {tuple(codes.shape)}, config wants "
            f"[N, {cfg.n_words}]")
    n = codes.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"{n} codes do not fit int32 ids")
    if directory == "auto":
        directory = "dense" if cfg.s_bits <= dense_threshold else "range"
    is_range = directory == "range"
    pbits = dir_lib.pick_range_pbits(
        n, cfg.s_bits,
        entry_block_size(cfg.n_words) if store_codes else ID_ROW_BLOCK)
    tables = []
    for t in range(cfg.n_tables):
        sorted_subs, sorted_ids = sort_table(codes, t, cfg.s_bits)
        d = _make_directory(sorted_subs, cfg.s_bits, directory, pbits)
        bmp = build_bitmap(sorted_subs, cfg.s_bits) if with_bitmap else None
        del sorted_subs
        tables.append(MIHTable(
            entry_ids=(sorted_ids if keep_entry_ids or with_bitmap
                       or not is_range else None),
            directory=d,
            entry_rows=(make_entry_rows(sorted_ids, codes)
                        if is_range and store_codes else None),
            entry_idrows=(make_entry_idrows(sorted_ids)
                          if is_range and not store_codes else None),
            entry_codes=(codes[sorted_ids.long()]
                         if store_codes and not is_range else None),
            bitmap=bmp))
        del sorted_ids
    return MIHIndex(cfg=cfg, tables=tables, n=n,
                    codes=codes if keep_codes else None)


# --------------------------------------------------------------------------
# Persistence: the reference's .npz keys, both directions
# --------------------------------------------------------------------------

def save_index(path: str, index: MIHIndex) -> None:
    """Write the index as the reference's ``save_index`` does: ``n``,
    ``bits``, ``n_tables``, ``codes`` (if kept), and per table its
    directory (``t{t}_se`` range, ``t{t}_offsets`` dense, ``t{t}_hashrows``
    hash, ``t{t}_keys`` sorted or prefix) and whichever of ``t{t}_ids``,
    ``t{t}_codes``, ``t{t}_rows``, ``t{t}_idrows``, ``t{t}_bitmap`` it
    holds, in the reference's dtypes (uint32 codes, rows, keys and words,
    int32 ids and offsets)."""
    arrs = {"n": np.asarray(index.n), "bits": np.asarray(index.cfg.bits),
            "n_tables": np.asarray(index.cfg.n_tables)}
    if index.codes is not None:
        arrs["codes"] = bits_lib.to_u32(index.codes)
    for t, tab in enumerate(index.tables):
        d = tab.directory
        if isinstance(d, dir_lib.DenseDirectory):
            arrs[f"t{t}_offsets"] = d.offsets.cpu().numpy()
        elif isinstance(d, dir_lib.HashDirectory):
            arrs[f"t{t}_hashrows"] = bits_lib.to_u32(d.rows)
        elif isinstance(d, dir_lib.RangeDirectory):
            arrs[f"t{t}_se"] = d.se.cpu().numpy()
        else:            # sorted or prefix: the sorted keys are the state
            arrs[f"t{t}_keys"] = bits_lib.to_u32(d.keys)
        if tab.entry_ids is not None:
            arrs[f"t{t}_ids"] = tab.entry_ids.cpu().numpy()
        bmp = None if tab.bitmap is None else tab.bitmap.words
        for key, x in (("codes", tab.entry_codes), ("rows", tab.entry_rows),
                       ("idrows", tab.entry_idrows), ("bitmap", bmp)):
            if x is not None:
                arrs[f"t{t}_{key}"] = bits_lib.to_u32(x)
    np.savez(path, **arrs)


def load_index(path: str, device=None) -> MIHIndex:
    """Read an index written by :func:`save_index` or by the reference's
    ``save_index`` onto ``device`` (by default the card, raising where
    there is none)."""
    device = bits_lib.entry_device(device)
    with np.load(path) as z:
        return index_from_arrays(z, device=device)


def _check_rows(t: int, rows, idrows, want: int) -> None:
    """A range table's blocked rows: exactly one layout, of its width."""
    if (rows is None) == (idrows is None):
        raise ValueError(f"table {t} must hold exactly one of t{t}_rows "
                         f"and t{t}_idrows")
    if rows is not None and (rows.ndim != 2 or rows.shape[1] != want):
        raise ValueError(f"t{t}_rows has shape {tuple(rows.shape)}; the "
                         f"blocked layout has {want} words per row")
    if idrows is not None and (idrows.ndim != 2
                               or idrows.shape[1] != ID_ROW_BLOCK):
        raise ValueError(f"t{t}_idrows has shape {tuple(idrows.shape)}"
                         f"; the compact layout has {ID_ROW_BLOCK} ids "
                         "per row")


def index_from_arrays(arrays: Mapping[str, np.ndarray],
                      device=None) -> MIHIndex:
    """The index held by the arrays of a saved ``.npz`` file (see
    :func:`save_index`), on ``device`` (by default the card, raising where
    there is none). A table's directory is read as the reference reads
    it: ``t{t}_offsets`` dense, else ``t{t}_hashrows`` hash, else
    ``t{t}_se`` range, else ``t{t}_keys`` as a prefix directory."""
    device = bits_lib.entry_device(device)
    cfg = MIHConfig(bits=int(arrays["bits"]), n_tables=int(arrays["n_tables"]))
    n = int(arrays["n"])
    want = entry_block_size(cfg.n_words) * _row_width(cfg.n_words)

    def tensor(key):
        return (bits_lib.as_codes(arrays[key], device)
                if key in arrays else None)

    tables = []
    for t in range(cfg.n_tables):
        if f"t{t}_offsets" in arrays:
            d = dir_lib.DenseDirectory(tensor(f"t{t}_offsets"))
        elif f"t{t}_hashrows" in arrays:
            d = dir_lib.HashDirectory(tensor(f"t{t}_hashrows"))
        elif f"t{t}_se" in arrays:
            d = dir_lib.RangeDirectory(se=tensor(f"t{t}_se"),
                                       s_bits=cfg.s_bits)
        elif f"t{t}_keys" in arrays:
            d = dir_lib.build_prefix(tensor(f"t{t}_keys"), cfg.s_bits)
        else:
            raise ValueError(f"table {t} holds no directory")
        rows, idrows = tensor(f"t{t}_rows"), tensor(f"t{t}_idrows")
        ids = tensor(f"t{t}_ids")
        if isinstance(d, dir_lib.RangeDirectory):
            _check_rows(t, rows, idrows, want)
        elif ids is None:
            raise ValueError(f"bucket table {t} holds no t{t}_ids")
        bmp = tensor(f"t{t}_bitmap")
        tables.append(MIHTable(
            entry_ids=ids, directory=d, entry_rows=rows, entry_idrows=idrows,
            entry_codes=tensor(f"t{t}_codes"),
            bitmap=None if bmp is None else Bitmap(words=bmp)))
    codes = tensor("codes")
    if codes is None and any(t.entry_rows is None and t.entry_codes is None
                             for t in tables):
        raise ValueError("an index whose tables hold no codes needs its "
                         "codes")
    return MIHIndex(cfg=cfg, tables=tables, n=n, codes=codes)
