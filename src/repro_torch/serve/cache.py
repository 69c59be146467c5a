"""Paged KV-cache pool for continuous batching (torch port of
``repro.serve.cache.PagedCachePool``: fp or quantized blocks).

Transformer K/V lives as fixed-size *blocks* in one ``(L, num_blocks,
block_size, KV, hd)`` pool per leaf and each sequence owns an ordered
block table into it, so a 6-token sequence holds one block while its
neighbour holds thirty.  Admission is gated on *free blocks*, capacity
grows block by block as a sequence decodes, and block exhaustion is an
allocation failure the scheduler turns into preempt-and-requeue (never a
crash).  ``length`` keeps slot semantics (``models.model.
cache_batch_axis``).

Physical block 0 is a reserved garbage sink: empty batch rows point their
block tables at it, so the fixed-shape decode step can write K/V for
inactive rows without touching any live sequence's blocks.

The pool tensors live on the model's device and the model writes them in
place; ``step_cache`` hands out the leaves plus the device copy of the
block tables: one persistent buffer, updated in place (on the card from
a pinned host copy, asynchronously) only after a table changed.  Every
read and write of the pool is on one stream, so a decode step captured in
a CUDA graph, an eager prefill and an in-place table update see each
other in stream order.  The ``length`` a step returns may be a captured
graph's output buffer, which its next replay overwrites: everything that
reads it (the next step copies it into its static input, a prefill
clones it) is enqueued before that replay, and nothing reads it on the
host.

Quantized-KV block layout (``kv_bits=...``), as the reference's:

- code leaves ``"k"``/``"v"``: ``(L, num_blocks, block_size, KV, hd)``
  int8 symmetric codes in ``[-qmax, qmax]``, or, when every layer is
  4-bit, ``(L, num_blocks, block_size, KV, hd//2)`` uint8 with two codes
  nibble-packed per byte (``quant.pack.kv_pack_int4``);
- scale leaves ``"k_scale"``/``"v_scale"``: ``(L, num_blocks,
  block_size, KV)`` float32, one absmax scale per (token, KV head),
  written by the same step that writes the codes; they ride in
  ``paged_keys`` and count toward ``cache_bytes``;
- ``"kv_qmax"``: ``(L,)`` float32 per-layer code ceiling ``2^(bits-1) -
  1``: per-layer bitwidths are data, not shape.

``kv_oracle=True`` (requires ``kv_bits``) keeps ``"k"``/``"v"`` as
float32 leaves holding the exact quantize-dequantize values
(``quant.pack.kv_qdq``) and no scale leaves: the quantized path's
``codes · scale`` is bitwise these floats, so the two pools give the same
tokens exactly.

Ported so far: ``prefix_cache=False``.  The prefix-cache hooks the
scheduler and engine call (``record_tokens``, ``record_token``,
``cow_for_write``) keep the reference's disabled early returns, and
``map_shared`` is absent, so the scheduler maps nothing.  Prefix caching,
mesh placement and the slot pool are later ROADMAP items.

Allocator invariants (as the reference's): an id is returned at most once
until freed and a double free raises; ``ensure`` never over-allocates and
reports exhaustion as ``False``; freeing returns every block.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.obs.trace import NULL_TRACER

PAGED_KEYS = ("k", "v")  # transformer KV pages; everything else is O(1)/seq


class PagedCachePool:
    """Block-granular KV pool + per-sequence block tables.

    ``num_seqs``  max concurrently-running sequences (decode batch rows).
    ``max_len``   per-sequence token capacity bound.
    ``block_size`` tokens per KV block.
    ``num_blocks`` physical blocks *including* the reserved garbage block
                  0.  Default allocates full capacity (num_seqs ×
                  blocks_per_seq + 1); pass less to oversubscribe.
    ``kv_bits``   quantize the KV blocks: an int (uniform) or one int per
                  layer, each in 2..8.  Uniform 4 selects the
                  nibble-packed uint8 container.
    ``kv_oracle`` with ``kv_bits``: store the exact QDQ values in float32
                  instead of codes (the token-parity oracle).
    """

    tracer = NULL_TRACER  # the engine points this at its tracer

    def __init__(self, model, num_seqs: int, max_len: int, *,
                 block_size: int = 16, num_blocks: int | None = None,
                 dtype=None, device=None, kv_bits=None,
                 kv_oracle: bool = False, prefix_cache: bool = False):
        if num_seqs < 1:
            raise ValueError("num_seqs must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if kv_oracle and kv_bits is None:
            raise ValueError("kv_oracle requires kv_bits")
        if prefix_cache:
            raise not_ported("prefix caching", "slice A, item 5")
        self.num_seqs = self.num_slots = num_seqs  # num_slots: engine compat
        self.max_len = max_len
        self.prefix_cache = False
        template = model.init_cache(num_seqs, max_len, dtype, device=device)
        self.paged_keys = tuple(k for k in PAGED_KEYS if k in template)
        L = template["k"].shape[0]
        if kv_bits is not None:
            bits = ([int(kv_bits)] * L if isinstance(kv_bits, (int, np.integer))
                    else [int(b) for b in kv_bits])
            if len(bits) != L:
                raise ValueError(f"kv_bits has {len(bits)} entries for {L} layers")
            if any(not 2 <= b <= 8 for b in bits):
                raise ValueError(f"kv_bits entries must be in 2..8: {bits}")
            kv_bits = bits
        self.kv_bits = kv_bits
        self.kv_oracle = bool(kv_oracle)
        T = template["k"].shape[2]                      # (L, B, T, KV, hd)
        self.block_size = min(block_size, T)
        self.blocks_per_seq = -(-T // self.block_size)
        usable = (num_blocks - 1 if num_blocks is not None
                  else num_seqs * self.blocks_per_seq)
        if usable < self.blocks_per_seq:
            raise ValueError(
                f"num_blocks={num_blocks} leaves {usable} usable blocks < "
                f"{self.blocks_per_seq} needed for a single full sequence")
        self.num_blocks = usable + 1  # + reserved garbage block 0
        self.device = template["k"].device

        pack4 = (self.kv_bits is not None and not self.kv_oracle
                 and all(b == 4 for b in self.kv_bits))
        KV = template["k"].shape[3]
        self.cache = {}
        for key, leaf in template.items():
            if key in self.paged_keys:
                hd, dt = leaf.shape[4], leaf.dtype
                if self.kv_bits is not None:
                    # oracle: f32 QDQ values; else int8 codes, or packed int4
                    dt = (torch.float32 if self.kv_oracle
                          else torch.uint8 if pack4 else torch.int8)
                    hd = hd // 2 if pack4 else hd
                self.cache[key] = torch.zeros(
                    (L, self.num_blocks, self.block_size, KV, hd),
                    dtype=dt, device=self.device)
            else:
                self.cache[key] = leaf
        del template
        if self.kv_bits is not None:
            self.cache["kv_qmax"] = torch.tensor(
                [float(2 ** (b - 1) - 1) for b in self.kv_bits],
                dtype=torch.float32, device=self.device)
            if not self.kv_oracle:
                for key in ("k_scale", "v_scale"):
                    self.cache[key] = torch.zeros(
                        (L, self.num_blocks, self.block_size, KV),
                        dtype=torch.float32, device=self.device)
                self.paged_keys = self.paged_keys + ("k_scale", "v_scale")

        self.block_tables = torch.zeros(
            (num_seqs, self.blocks_per_seq), dtype=torch.int32)  # host copy
        # min-heaps: heappop -> lowest id (sorted ranges are valid heaps)
        self._free_seqs = list(range(num_seqs))
        self._active: set[int] = set()
        self._free_blocks = list(range(1, self.num_blocks))
        self._seq_blocks: dict[int, list[int]] = {}
        # prefix-cache counters, read by the engine's metrics (always 0)
        self.prefix_lookups = self.prefix_hits = self.prefix_hit_tokens = 0
        self.cow_copies = self.prefix_evictions = 0
        self.prefix_cached_blocks = self.blocks_shared = 0
        # device mirror of block_tables, updated in place when it changed;
        # on the card through a pinned staging copy that is rewritten only
        # after the event covering its last transfer
        self._bt_dev = torch.zeros_like(self.block_tables, device=self.device)
        self._bt_stage = (self.block_tables.pin_memory()
                          if self.device.type == "cuda" else None)
        self._bt_event = None
        self._bt_dirty = True
        # per-sequence token bound: blocks_per_seq · block_size tokens
        self.length_bound = self.blocks_per_seq * self.block_size

    # ----------------------------------------------------------- bookkeeping
    @property
    def num_free_blocks(self) -> int:
        return len(self._free_blocks)

    def occupancy(self) -> float:
        return len(self._active) / self.num_seqs

    def block_occupancy(self) -> float:
        usable = self.num_blocks - 1
        return 1.0 - self.num_free_blocks / usable if usable else 0.0

    def blocks_needed(self, n_tokens: int) -> int:
        n = min(n_tokens, self.blocks_per_seq * self.block_size)
        return -(-n // self.block_size)

    def can_admit(self, n_tokens: int, reserve_blocks: int = 0,
                  tokens=None) -> bool:
        """Admissible iff a row is free, the sequence fits a row's
        capacity, and the free blocks cover the whole prompt PLUS
        ``reserve_blocks`` of headroom (one per running sequence, so a
        fresh admission is not preempted at once by its neighbours'
        growth).  ``tokens`` is the prefix-cache hint, unused here."""
        if not self._free_seqs or n_tokens > self.length_bound:
            return False
        return self.num_free_blocks >= self.blocks_needed(n_tokens) + reserve_blocks

    def alloc_seq(self) -> int:
        if not self._free_seqs:
            raise RuntimeError(f"all {self.num_seqs} sequences in use")
        seq = heapq.heappop(self._free_seqs)
        self._active.add(seq)
        self._seq_blocks[seq] = []
        return seq

    def ensure(self, seq: int, n_tokens: int) -> bool:
        """Grow ``seq`` to cover ``n_tokens`` (clamped to its capacity).
        Returns False — allocating *nothing* — when the free blocks cannot
        cover the growth; the scheduler answers with preemption."""
        if seq not in self._active:
            raise ValueError(f"seq {seq} is not allocated")
        have = self._seq_blocks[seq]
        need = self.blocks_needed(n_tokens) - len(have)
        if need <= 0:
            return True
        if need > self.num_free_blocks:
            return False
        for _ in range(need):
            blk = heapq.heappop(self._free_blocks)
            self.block_tables[seq, len(have)] = blk
            have.append(blk)
        self._bt_dirty = True
        return True

    def free_seq(self, seq: int) -> None:
        if seq not in self._active:
            raise ValueError(f"seq {seq} is not allocated")
        self._active.remove(seq)
        for blk in self._seq_blocks.pop(seq):
            heapq.heappush(self._free_blocks, blk)
        self.block_tables[seq] = 0            # back to the garbage sink
        self._bt_dirty = True
        heapq.heappush(self._free_seqs, seq)

    # ------------------------------------------- prefix-cache hooks (off)
    def record_tokens(self, seq: int, tokens) -> None:
        """No-op: the prefix cache is off (``prefix_cache=False``)."""

    def record_token(self, seq: int, token) -> None:
        """No-op: the prefix cache is off (``prefix_cache=False``)."""

    def cow_for_write(self, seq: int, start: int, end: int | None = None) -> bool:
        """Nothing is shared, so every write position is already private."""
        if seq not in self._active:
            raise ValueError(f"seq {seq} is not allocated")
        return True

    # ------------------------------------------------------------- cache ops
    def step_cache(self) -> dict:
        """Leaves for one prefill-chunk/decode call plus the device copy of
        the block tables."""
        d = dict(self.cache)
        d["block_tables"] = self.block_tables_dev()
        return d

    def block_tables_dev(self) -> torch.Tensor:
        """The persistent device copy of the block tables, brought up to
        date in stream order."""
        if self._bt_dirty:
            if self._bt_stage is None:
                self._bt_dev.copy_(self.block_tables)
            else:
                if self._bt_event is not None:
                    self._bt_event.synchronize()
                self._bt_stage.copy_(self.block_tables)
                self._bt_dev.copy_(self._bt_stage, non_blocking=True)
                self._bt_event = torch.cuda.Event()
                self._bt_event.record()
            self._bt_dirty = False
        return self._bt_dev

    def accept(self, cache: dict) -> None:
        """Take back the cache a model call returned."""
        cache = dict(cache)
        cache.pop("block_tables", None)  # host copy is authoritative
        self.cache = cache

    def cache_bytes(self) -> int:
        """Paged-leaf bytes (the number "equal cache bytes" compares)."""
        return sum(self.cache[k].numel() * self.cache[k].element_size()
                   for k in self.paged_keys)
