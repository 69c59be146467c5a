"""KV-cache pools for continuous batching (torch port of
``repro.serve.cache``): the paged ``PagedCachePool`` (fp or quantized
blocks) and the slot-granular ``SlotCachePool``.

Transformer K/V lives as fixed-size *blocks* in one ``(L, num_blocks,
block_size, KV, hd)`` pool per leaf and each sequence owns an ordered
block table into it, so a 6-token sequence holds one block while its
neighbour holds thirty.  Admission is gated on *free blocks*, capacity
grows block by block as a sequence decodes, and block exhaustion is an
allocation failure the scheduler turns into preempt-and-requeue (never a
crash).  ``length`` keeps slot semantics (``models.model.
cache_batch_axis``).

O(1)-state families (RWKV's ``wkv`` and token-shift rows, hymba's Mamba
``ssm_h``/``ssm_conv``) keep that state in slot rows beside the blocks:
``(L, num_seqs, ...)`` leaves the model writes in place.  RWKV has no
paged K/V at all, so its pool has no blocks (``blocks_per_seq = 0``),
admission needs only a free row, ``length_bound`` is None, and
``kv_bits`` is refused.  A row's previous occupant's state is never read:
the model's chunk body starts a row's first chunk (start 0) from zero
state.  ``recurrent_keys`` names these leaves; the spec path snapshots
them before a draft roll.

Sliding-window (ring) models: a sequence's cache is a ring of ``Tc =
min(max_len, window)`` tokens, and the ring arithmetic needs
``blocks_per_seq * block_size == Tc``, so the block size shrinks to the
largest divisor of ``Tc`` not above the one asked for.  A ring fits any
sequence length (``length_bound`` is None), and it rewrites its blocks in
place, so the prefix cache turns itself off for it.

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

Prefix caching (``prefix_cache=True``, the default, as the
reference's): full blocks are shared across sequences.  Every block is
refcounted, and a trie maps *full-block token content* to the physical
block holding its KV, so admission splices a shared system prompt into a
new sequence's block table with an incref instead of prefilling it
again.  The trie is per pool: one pool serves one packed policy at one KV
layout, and ``flush_prefix_cache()`` drops the index when the weights
change.  Block lifecycle (the reference's):

- free -> owned (refcount 1) by ``alloc_seq``/``ensure``;
- owned -> published into the trie by ``record_tokens``/``record_token``
  once the block is full of fed tokens;
- published -> shared (refcount > 1) by ``map_shared`` (incref);
- refcount 0: a published block parks in the trie as *cached*
  (evictable, least recently used first, leaves first), an unpublished
  one returns to the free heap;
- a write into a shared block copies it first (``cow_for_write``): a
  fresh block gets a bitwise copy of every paged leaf (codes and scales)
  and the shared one is decref'd.

The copy is made in place on the pool's own tensors (``leaf[:, dst] =
leaf[:, src]`` for every paged leaf), so the leaves keep their addresses:
a decode step captured in a CUDA graph binds them by address and is not
captured again.  Nibble-packed int4 codes are copied as bytes.

Allocator invariants (as the reference's): an id is returned at most once
until freed and a double free raises; ``ensure`` never over-allocates and
reports exhaustion as ``False``; freeing returns every block; one
refcount per owning sequence, never negative; a shared block never
reaches the free heap; ``owned + heap + cached == num_blocks - 1``.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.models.model import cache_batch_axis, recurrent_keys
from repro_torch.obs.trace import NULL_TRACER

PAGED_KEYS = ("k", "v")  # transformer KV pages; everything else is O(1)/seq


class DeviceTable:
    """A persistent device copy of a host ``int32`` table, updated in
    place in stream order: directly on the CPU, and on the card through a
    pinned staging copy that is rewritten only after the event covering
    its last transfer.  The device buffer keeps its address, so a graph
    that copies it in at each replay reads the update in stream order."""

    def __init__(self, host: torch.Tensor, device):
        self.dev = torch.zeros_like(host, device=device)
        self._stage = host.pin_memory() if self.dev.is_cuda else None
        self._event = None

    def upload(self, host: torch.Tensor) -> torch.Tensor:
        if self._stage is None:
            self.dev.copy_(host)
        else:
            if self._event is not None:
                self._event.synchronize()
            self._stage.copy_(host)
            self.dev.copy_(self._stage, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        return self.dev


class _PrefixNode:
    """One full block's worth of token content in the prefix trie:
    ``key`` the ``block_size`` token ids it holds, ``block`` the physical
    block storing their KV, ``parent``/``children`` the chain (a child's
    key is the next full block of tokens), ``last_use`` a monotone tick
    for LRU eviction among refcount-0 nodes."""

    __slots__ = ("key", "parent", "children", "block", "depth", "last_use")

    def __init__(self, key, parent, block, depth):
        self.key = key
        self.parent = parent
        self.children: dict[tuple, _PrefixNode] = {}
        self.block = block
        self.depth = depth
        self.last_use = 0


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
    ``prefix_cache`` share full KV blocks across sequences through the
                  refcounted trie (module docstring).  Off for a model
                  whose cache holds state beyond the paged KV, where a
                  mapped prefix would not reproduce the cold tokens.
    """

    tracer = NULL_TRACER  # the engine points this at its tracer

    def __init__(self, model, num_seqs: int, max_len: int, *,
                 block_size: int = 16, num_blocks: int | None = None,
                 dtype=None, device=None, kv_bits=None,
                 kv_oracle: bool = False, prefix_cache: bool = True):
        if num_seqs < 1:
            raise ValueError("num_seqs must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if kv_oracle and kv_bits is None:
            raise ValueError("kv_oracle requires kv_bits")
        self.num_seqs = self.num_slots = num_seqs  # num_slots: engine compat
        self.max_len = max_len
        template = model.init_cache(num_seqs, max_len, dtype, device=device)
        self.paged_keys = tuple(k for k in PAGED_KEYS if k in template)
        if kv_bits is not None and not self.paged_keys:
            raise ValueError(
                "kv_bits quantizes paged attention KV blocks; this model "
                "family keeps O(1) recurrent state (nothing paged to "
                "quantize)")
        L = template[self.paged_keys[0]].shape[0] if self.paged_keys else 0
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
        self._ring = (getattr(model.cfg, "sliding_window", None) is not None
                      and bool(self.paged_keys))
        if self.paged_keys:
            T = template["k"].shape[2]                  # (L, B, T, KV, hd)
            bs = min(block_size, T)
            if self._ring:   # the ring arithmetic needs blocks_per_seq * bs == T
                while T % bs:
                    bs -= 1
            self.block_size = bs
            self.blocks_per_seq = -(-T // self.block_size)
        else:            # O(1)-state family: slot rows, no blocks at all
            self.block_size = block_size
            self.blocks_per_seq = 0
        usable = (num_blocks - 1 if num_blocks is not None
                  else num_seqs * self.blocks_per_seq)
        if self.blocks_per_seq and usable < self.blocks_per_seq:
            raise ValueError(
                f"num_blocks={num_blocks} leaves {usable} usable blocks < "
                f"{self.blocks_per_seq} needed for a single full sequence")
        self.num_blocks = usable + 1  # + reserved garbage block 0
        self.device = template["length"].device

        pack4 = (self.kv_bits is not None and not self.kv_oracle
                 and all(b == 4 for b in self.kv_bits))
        self.cache = {}
        for key, leaf in template.items():
            if key in self.paged_keys:
                KV, hd, dt = leaf.shape[3], leaf.shape[4], leaf.dtype
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
        # the O(1) per-row state beside the blocks (snapshotted by spec)
        self.recurrent_keys = recurrent_keys(template)
        # sound only where the paged KV is the whole per-token state and
        # is never rewritten in place (a ring is)
        self.prefix_cache = bool(prefix_cache and self.blocks_per_seq
                                 and not self.recurrent_keys and not self._ring)
        del template
        if self.kv_bits is not None:
            self.cache["kv_qmax"] = torch.tensor(
                [float(2 ** (b - 1) - 1) for b in self.kv_bits],
                dtype=torch.float32, device=self.device)
            if not self.kv_oracle:
                KV = self.cache["k"].shape[3]
                for key in ("k_scale", "v_scale"):
                    self.cache[key] = torch.zeros(
                        (L, self.num_blocks, self.block_size, KV),
                        dtype=torch.float32, device=self.device)
                self.paged_keys = self.paged_keys + ("k_scale", "v_scale")

        self.block_tables = torch.zeros(
            (num_seqs, max(self.blocks_per_seq, 1)), dtype=torch.int32)  # host copy
        # min-heaps: heappop -> lowest id (sorted ranges are valid heaps)
        self._free_seqs = list(range(num_seqs))
        self._active: set[int] = set()
        self._free_blocks = list(range(1, self.num_blocks))
        self._seq_blocks: dict[int, list[int]] = {}
        # prefix cache: refcounts and the trie over full-block content
        self._refcount: dict[int, int] = {}         # block -> #owning seqs
        self._root = _PrefixNode(None, None, 0, 0)
        self._node_of: dict[int, _PrefixNode] = {}  # any published block
        self._cached: dict[int, _PrefixNode] = {}   # refcount 0, evictable
        self._seq_tokens: dict[int, list[int]] = {}  # fed tokens per seq
        self._seq_node: dict[int, _PrefixNode] = {}  # deepest published node
        self._seq_pub: dict[int, int] = {}           # #published full blocks
        self._tick = 0
        self.prefix_lookups = 0       # admissions that consulted the trie
        self.prefix_hits = 0          # ... that mapped >= 1 shared block
        self.prefix_hit_tokens = 0    # prompt tokens served from the trie
        self.cow_copies = 0
        self.prefix_evictions = 0
        # device mirror of block_tables, updated in place when it changed
        self._bt_dev = DeviceTable(self.block_tables, self.device)
        self._bt_dirty = True
        # per-sequence token bound: blocks_per_seq · block_size tokens, or
        # None for a ring or O(1) state, which fit any length
        self.length_bound = (self.blocks_per_seq * self.block_size
                             if self.blocks_per_seq and not self._ring else None)

    # ----------------------------------------------------------- bookkeeping
    @property
    def num_free(self) -> int:
        return len(self._free_seqs)

    @property
    def num_free_blocks(self) -> int:
        """Blocks an allocation can claim: the free heap plus the cached
        (refcount-0, trie-indexed) blocks, which evict on demand."""
        return len(self._free_blocks) + len(self._cached)

    @property
    def blocks_shared(self) -> int:
        """Physical blocks currently mapped by more than one sequence."""
        return sum(1 for c in self._refcount.values() if c > 1)

    @property
    def prefix_cached_blocks(self) -> int:
        """Refcount-0 blocks held in the trie awaiting reuse or eviction."""
        return len(self._cached)

    def occupancy(self) -> float:
        return len(self._active) / self.num_seqs

    def block_occupancy(self) -> float:
        usable = self.num_blocks - 1
        return 1.0 - self.num_free_blocks / usable if usable else 0.0

    def blocks_needed(self, n_tokens: int) -> int:
        if not self.blocks_per_seq:
            return 0
        n = min(n_tokens, self.blocks_per_seq * self.block_size)
        return -(-n // self.block_size)

    def can_admit(self, n_tokens: int, reserve_blocks: int = 0,
                  tokens=None) -> bool:
        """Admissible iff a row is free, the sequence fits a row's
        capacity, and the reclaimable blocks cover the whole prompt PLUS
        ``reserve_blocks`` of headroom (one per running sequence, so a
        fresh admission is not preempted at once by its neighbours'
        growth).  ``tokens`` (the replay token ids) lets the gate count
        only *new* blocks: trie-matched prefix blocks arrive by incref.
        A block-aligned full-prompt hit costs one block more, the copy of
        the last shared block that the one-token tail prefill writes."""
        if not self._free_seqs:
            return False
        if self.length_bound is not None and n_tokens > self.length_bound:
            return False
        if not self.blocks_per_seq:
            return True  # O(1) state: a free row is the whole decision
        need = self.blocks_needed(n_tokens)
        free = self.num_free_blocks
        if tokens is not None and self.prefix_cache:
            hits = self._match_nodes(tokens)
            if hits:
                need -= len(hits)
                if len(hits) * self.block_size >= len(tokens):
                    need += 1  # admission COW of the last shared block
                # mapped cached blocks leave the reclaimable set
                free -= sum(1 for n in hits if n.block in self._cached)
        return free >= need + reserve_blocks

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
            blk = self._alloc_block()
            self.block_tables[seq, len(have)] = blk
            have.append(blk)
        self._bt_dirty = True
        return True

    def free_seq(self, seq: int) -> None:
        if seq not in self._active:
            raise ValueError(f"seq {seq} is not allocated")
        self._active.remove(seq)
        for blk in self._seq_blocks.pop(seq):
            self._decref(blk)
        self.block_tables[seq] = 0            # back to the garbage sink
        self._bt_dirty = True
        heapq.heappush(self._free_seqs, seq)
        self._seq_tokens.pop(seq, None)
        self._seq_node.pop(seq, None)
        self._seq_pub.pop(seq, None)

    def _alloc_block(self) -> int:
        """Claim one block at refcount 1: the free heap first, then evict
        the least recently used refcount-0 trie leaf.  The caller has
        checked ``num_free_blocks``."""
        blk = heapq.heappop(self._free_blocks) if self._free_blocks else self._evict_lru()
        self._refcount[blk] = 1
        return blk

    def _evict_lru(self) -> int:
        """Evict the least recently used cached node with no cached
        children (the deepest cached node of any chain qualifies, so one
        exists while ``_cached`` is not empty).  It may still have owned
        children; evicting it detaches them from the root, so later
        lookups match a shorter prefix, never stale content."""
        best = None
        for blk, node in self._cached.items():
            if any(c.block in self._cached for c in node.children.values()):
                continue
            key = (node.last_use, -node.depth, blk)
            if best is None or key < best[0]:
                best = (key, blk, node)
        assert best is not None, "cached blocks exist but none evictable"
        _, blk, node = best
        del self._cached[blk]
        self._detach(node)
        self.prefix_evictions += 1
        self.tracer.instant("prefix.evict", block=blk, depth=node.depth)
        return blk

    def _detach(self, node: _PrefixNode) -> None:
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        node.parent = None
        self._node_of.pop(node.block, None)

    def _decref(self, blk: int) -> None:
        """Drop one ownership reference.  A still-shared block only
        decrements: it never reaches the free heap while another sequence
        reads it.  At refcount 0 a published block parks in the trie as
        evictable; an unpublished one returns to the heap."""
        count = self._refcount.get(blk, 0)
        if count <= 0:
            raise ValueError(f"block {blk} is not allocated")
        if count > 1:
            self._refcount[blk] = count - 1
            return
        del self._refcount[blk]
        node = self._node_of.get(blk)
        if node is not None:
            self._tick += 1
            node.last_use = self._tick
            self._cached[blk] = node
        else:
            heapq.heappush(self._free_blocks, blk)

    # ---------------------------------------------------------- prefix cache
    def _block_chunks(self, tokens):
        bs = self.block_size
        for i in range(len(tokens) // bs):
            yield tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def _match_nodes(self, tokens) -> list[_PrefixNode]:
        """Longest chain of trie nodes matching ``tokens``' full blocks."""
        node, out = self._root, []
        for key in self._block_chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            out.append(child)
            node = child
        return out

    def map_shared(self, seq: int, tokens) -> int:
        """Map the longest trie-matched prefix of ``tokens`` into a fresh
        sequence's block table, one incref per block; returns how many
        prompt tokens are thereby cached (0 = no hit).  The count is
        capped at ``len(tokens) - 1``: the last prompt token is always
        prefilled for its logits, and when the whole prompt is
        block-aligned in the trie it re-enters the last shared block, which
        is copied here, while ``can_admit``'s block count still holds."""
        if not self.prefix_cache or not len(tokens):
            return 0
        if seq not in self._active:
            raise ValueError(f"seq {seq} is not allocated")
        if self._seq_blocks[seq]:
            raise ValueError("map_shared requires a fresh (empty) sequence")
        self.prefix_lookups += 1
        nodes = self._match_nodes(tokens)
        if not nodes:
            return 0
        have = self._seq_blocks[seq]
        self._tick += 1
        for i, node in enumerate(nodes):
            blk = node.block
            self._refcount[blk] = self._refcount.get(blk, 0) + 1
            self._cached.pop(blk, None)  # reserved again: not evictable
            node.last_use = self._tick
            self.block_tables[seq, i] = blk
            have.append(blk)
        self._seq_node[seq] = nodes[-1]
        self._seq_pub[seq] = len(nodes)
        self._bt_dirty = True
        cached = min(len(nodes) * self.block_size, len(tokens) - 1)
        self.prefix_hits += 1
        self.prefix_hit_tokens += cached
        if cached < len(nodes) * self.block_size:
            ok = self.cow_for_write(seq, cached)
            assert ok, "can_admit reserved the admission-COW block"
        return cached

    def record_tokens(self, seq: int, tokens) -> None:
        """Record ``seq``'s fed tokens (a prompt replay) and publish every
        newly completed full block into the trie.  Idempotent for
        prefixes already recorded."""
        if not self.prefix_cache or seq not in self._active:
            return
        toks = self._seq_tokens.setdefault(seq, [])
        if len(tokens) > len(toks):
            toks[:] = [int(t) for t in tokens]
        self._publish(seq)

    def record_token(self, seq: int, token) -> None:
        """Append one fed token (a decode or spec advance) and publish if
        it completed a block.  Callers record only realized tokens whose
        KV writes have landed: a rejected draft or a discarded lookahead
        token never publishes."""
        if not self.prefix_cache or seq not in self._active:
            return
        self._seq_tokens.setdefault(seq, []).append(int(token))
        self._publish(seq)

    def _publish(self, seq: int) -> None:
        toks = self._seq_tokens.get(seq, [])
        have = self._seq_blocks[seq]
        bs = self.block_size
        done = self._seq_pub.get(seq, 0)
        if done < 0:  # poisoned by flush_prefix_cache mid-flight
            return
        node = self._seq_node.get(seq) or self._root
        while (done + 1) * bs <= len(toks) and done < len(have):
            key = tuple(toks[done * bs:(done + 1) * bs])
            child = node.children.get(key)
            if child is None and have[done] not in self._node_of:
                child = _PrefixNode(key, node, have[done], node.depth + 1)
                node.children[key] = child
                self._node_of[have[done]] = child
            if child is None:
                # this physical block already indexes other content (it
                # was copied from a published block): leave the trie as is
                break
            self._tick += 1
            child.last_use = self._tick
            node = child
            done += 1
        self._seq_node[seq] = node
        self._seq_pub[seq] = done

    def cow_for_write(self, seq: int, start: int, end: int | None = None) -> bool:
        """Make every block covering write positions ``[start, end)``
        privately owned before a KV write lands there: a shared block
        (refcount > 1) is replaced by a fresh block holding a bitwise copy
        of every paged leaf, and decref'd.  Returns False, changing
        nothing further, if allocation is exhausted (the scheduler then
        preempts, as for ``ensure``).  A sole owner's published block is
        not copied: the only writes into it store the same values again."""
        if seq not in self._active:
            raise ValueError(f"seq {seq} is not allocated")
        have = self._seq_blocks[seq]
        if not self.prefix_cache or not have:
            return True
        end = start + 1 if end is None else max(end, start + 1)
        first = start // self.block_size
        last = min((end - 1) // self.block_size, len(have) - 1)
        for i in range(first, last + 1):
            blk = have[i]
            if self._refcount.get(blk, 0) <= 1:
                continue
            if not self.num_free_blocks:
                return False
            new = self._alloc_block()
            self._cow_copy(blk, new)
            self._refcount[blk] -= 1
            have[i] = new
            self.block_tables[seq, i] = new
            self._bt_dirty = True
            self.cow_copies += 1
            self.tracer.instant("cow", seq=seq, src=blk, dst=new)
        return True

    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy physical block ``src`` into ``dst`` in every paged leaf
        (codes and scales), in place and in stream order."""
        for key in self.paged_keys:
            leaf = self.cache[key]
            leaf[:, dst].copy_(leaf[:, src])

    def flush_prefix_cache(self) -> None:
        """Drop the prefix index: cached blocks return to the free heap,
        the trie empties, and sequences in flight stop publishing (their
        KV predates whatever invalidated the cache, a weight swap).
        Shared mappings stay valid: live sequences keep their refcounts
        and block tables."""
        self.tracer.instant("prefix.flush", cached_blocks=len(self._cached))
        for blk in self._cached:
            heapq.heappush(self._free_blocks, blk)
        self._cached.clear()
        self._node_of.clear()
        self._root = _PrefixNode(None, None, 0, 0)
        for seq in self._seq_node:
            self._seq_node[seq] = self._root
        for seq in self._seq_pub:
            self._seq_pub[seq] = -1  # poison: no re-publish of stale KV

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
            self._bt_dev.upload(self.block_tables)
            self._bt_dirty = False
        return self._bt_dev.dev

    def accept(self, cache: dict) -> None:
        """Take back the cache a model call returned."""
        cache = dict(cache)
        cache.pop("block_tables", None)  # host copy is authoritative
        self.cache = cache

    def cache_bytes(self) -> int:
        """Paged-leaf bytes (the number "equal cache bytes" compares)."""
        return sum(self.cache[k].numel() * self.cache[k].element_size()
                   for k in self.paged_keys)


class SlotCachePool:
    """Slot-granular pool: one contiguous ``cache_len(max_len)``-token
    cache row per sequence, ``(L, num_slots, T, KV, hd)`` K and V leaves
    (the model's ``init_cache``), and the O(1) state rows of a recurrent
    family.  Admission splices a batch-1 cache from the full-prompt
    ``prefill`` into the row in place (``write``: every leaf of the row,
    state included), so the leaves keep their addresses and a captured
    decode step binds them once.  fp KV only, and no block sharing, as
    the reference's."""

    tracer = NULL_TRACER  # the engine points this at its tracer

    def __init__(self, model, num_slots: int, max_len: int, dtype=None, device=None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.max_len = max_len
        self.cache = model.init_cache(num_slots, max_len, dtype, device=device)
        # per-sequence token bound (None: a ring or O(1) state fits any length)
        self.length_bound = (max_len if "k" in self.cache
                             and getattr(model.cfg, "sliding_window", None) is None
                             else None)
        # min-heap: heappop -> lowest id (a sorted range is already a heap)
        self._free = list(range(num_slots))
        self._active: set[int] = set()

    def occupancy(self) -> float:
        return len(self._active) / self.num_slots

    def can_admit(self, n_tokens: int, reserve_blocks: int = 0, tokens=None) -> bool:
        """A free slot and a sequence that fits its row.  ``reserve_blocks``
        and ``tokens`` (the paged pool's headroom and prefix hint) are
        accepted and ignored: a row is preallocated and never shared."""
        if self.length_bound is not None and n_tokens > self.length_bound:
            return False
        return bool(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(f"all {self.num_slots} slots in use")
        slot = heapq.heappop(self._free)
        self._active.add(slot)
        return slot

    alloc_seq = alloc

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """A row is preallocated to its full length: always True."""
        return True

    def free(self, slot: int) -> None:
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not allocated")
        self._active.remove(slot)
        heapq.heappush(self._free, slot)

    free_seq = free

    def write(self, slot: int, single_cache: dict) -> None:
        """Splice a batch-1 cache (one prefilled sequence) into ``slot``:
        K/V in place, ``length`` as a new tensor (the pool's may be a
        captured step's output buffer)."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not allocated")
        if set(single_cache) != set(self.cache):
            raise ValueError(f"cache keys {sorted(single_cache)} != pool {sorted(self.cache)}")
        for key, leaf in self.cache.items():
            ax = cache_batch_axis(key)
            want = leaf.shape[:ax] + (1,) + leaf.shape[ax + 1:]
            if tuple(single_cache[key].shape) != tuple(want):
                raise ValueError(f"cache[{key!r}] shape {tuple(single_cache[key].shape)} "
                                 f"!= {tuple(want)}")
        for key, leaf in self.cache.items():
            if key != "length":
                leaf.narrow(cache_batch_axis(key), slot, 1).copy_(single_cache[key])
        length = self.cache["length"].clone()
        length[slot:slot + 1] = single_cache["length"].to(length.dtype)
        self.cache["length"] = length

    def step_cache(self) -> dict:
        return dict(self.cache)

    def accept(self, cache: dict) -> None:
        self.cache = dict(cache)

    def cache_bytes(self) -> int:
        """K/V leaf bytes (what the paged pool's equal-bytes claim compares)."""
        return sum(self.cache[k].numel() * self.cache[k].element_size()
                   for k in PAGED_KEYS if k in self.cache)
