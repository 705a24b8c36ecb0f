"""Continuous batching over a celled KV cache (counterpart of
ggml_imax_tpu/runtime/batched.py; the reference ggml's main-batched
semantics).

The KV arena (batch 1) is a pool of n_ctx cells, each tagged with a
position and a bitmask of the sequences that own it. A step writes its
ubatch rows into cells tagged (pos, seq); a token sees a cell iff the cell
belongs to its sequence and cell.pos <= token.pos; forking a sequence only
adds its id to the prefix's cells. The registry lives on the host in
numpy; each step uploads it with the ubatch in ONE packed int32 tensor
[tokens|positions|seqs|cells|cell_pos|cell_seq(|sampling params as f32
bits)], and the mask is built on the card (models.common.cells_attention_mask).
The last cell is reserved as the trash destination of ubatch pad rows,
whose seq id MAX_SEQ - 1 is never handed out, so they are never visible.

Differences from the reference:
- no ``stacked=`` keyword: the stacked weights and scan over layers are a
  TPU mechanism the port does not have. The port's per-layer forward takes
  the same attention routes (a decode-only ubatch goes to the cells kernels
  through ``cells_kernel``), so what ``stacked=True`` selected is the only
  behaviour here;
- a k-step decode chunk (the reference's jitted lax.scan, `step_chunk` and
  `run_pipelined`) is k forwards and k on-device draws against static
  tensors of its (k, nb): the packed upload in, the (k, nb) ids out. On the
  card it is captured once into a CUDA graph and replayed; on the CPU it
  runs eagerly. Its uniform draws come from the engine's generator into a
  buffer before each run (one torch.rand), so the step/step_chunk key
  schedule of the reference is not reproduced, only its distribution;
- the upload goes through a ring of two pinned staging buffers and copies
  that do not wait for the stream, and a chunk's ids come back the same
  way into one of two pinned slots, so `run_pipelined` can run chunk j + 1
  (fed chunk j's last ids on the card) before the host reads chunk j.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from .._device import resolve_device
from ..models.common import cells_attention_mask
from ..ops.sampling import (gumbel, sample_device, sample_greedy,
                            sample_gumbel, sample_host)
from .engine import CapturedStep

MAX_SEQ = 32
_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return n


@dataclass
class Request:
    seq: int
    prompt: list
    n_predict: int
    top_k: int = 40
    top_p: float = 0.9
    temp: float = 0.8
    eos_id: int | None = None
    out: list = field(default_factory=list)
    pos: int = 0                     # next position to fill
    n_prompt_done: int = 0
    done: bool = False
    rng: np.random.Generator = field(default_factory=np.random.default_rng)
    logits: np.ndarray | None = None
    next_tok: int | None = None


class _Staging:
    """Copies of packed int32 inputs to the card that do not wait for the
    stream: through a ring of two pinned host buffers, each refilled only
    once its last copy has landed (an event recorded on the copy). A copy
    from pageable memory would wait for every launch queued before it. On
    the CPU, a plain copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bufs = [None, None]
        self.events = [None, None]
        self.i = 0

    def __call__(self, arr: np.ndarray, dst: torch.Tensor):
        src = torch.from_numpy(arr)
        if self.device.type != "cuda":
            dst.copy_(src)
            return
        i, self.i = self.i, self.i ^ 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        if self.bufs[i] is None or self.bufs[i].numel() < src.numel():
            self.bufs[i] = torch.empty(src.numel(), dtype=src.dtype,
                                       pin_memory=True)
        buf = self.bufs[i][:src.numel()]
        buf.copy_(src)
        dst.copy_(buf, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record()


class BatchedEngine:
    """Continuous-batching server loop over a model module exposing
    forward(..., cells=, mask=, cells_kernel=, fused_kv_update=) and
    init_cache (gpt2, gptj). The params are
    used as given (for the kernels: prepare_fused, then
    ops.qmm.params_repack). device: the card unless "cpu" is passed.

    on_device_sampling: sample on the card with per-request temp, top_k and
    top_p (a (3, nb) row per ubatch) and fetch only token ids; the draws
    come from a torch.Generator seeded with `seed`. top_k sets the static
    candidate window, max(64, top_k). fused_kv_update: decode-only ubatches
    write their K/V rows inside the attention kernel (the fused cells
    route; a model without that route raises).

    `n_ubatches` counts the ubatches run, "mixed" (a prompt chunk joined)
    and "decode" (decode rows only; each step of a chunk counts, a
    discarded pipelined chunk too).

    The KV arena is allocated once (the captured chunks hold its
    addresses); the chunks are cached per (k, nb) and share one graph
    memory pool."""

    def __init__(self, model_module, cfg, params, *, n_ctx: int | None = None,
                 compute_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
                 on_device_sampling: bool = False, top_k: int = 40,
                 seed: int = 0, n_ubatch: int = 512,
                 fused_kv_update: bool = False, device=None):
        self.device = resolve_device(device)
        self.model = model_module
        self.cfg = cfg
        self.params = params
        self.n_ctx = n_ctx or cfg.n_ctx
        self.compute_dtype = compute_dtype
        self.kv_dtype = kv_dtype
        # max tokens per ubatch (the reference's n_batch): long prompts
        # prefill across several steps, and decode rows keep joining
        self.n_ubatch = n_ubatch
        self.on_device_sampling = on_device_sampling
        self._k_max = max(64, top_k)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.fused_kv_update = fused_kv_update
        self.n_ubatches = {"mixed": 0, "decode": 0}

        # host-side cell registry; the last cell is the pad rows' trash cell
        self.cell_pos = np.full(self.n_ctx, -1, np.int32)
        self.cell_seq = np.zeros(self.n_ctx, np.uint32)
        self.trash_cell = self.n_ctx - 1
        self.head = 0
        self.requests: dict[int, Request] = {}
        self._next_seq = 0
        self.cache = model_module.init_cache(cfg, batch=1, n_ctx=self.n_ctx,
                                             dtype=kv_dtype, device=self.device)
        self.graph_pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None   # the chunks' graphs
        self._chunks: dict = {}
        self._staging = _Staging(self.device)

    # -- cell registry ------------------------------------------------------
    def _find_slot(self, n: int) -> int:
        """Head-cursor slot allocator: the run ahead of the cursor is free
        in the common case (an O(n) check and a bump); on collision, one
        first-fit scan that prefers runs at or after the cursor."""
        nc = self.trash_cell               # usable cells: [0, trash_cell)
        if n > nc:
            raise RuntimeError("KV cache full")
        h = self.head
        if h + n <= nc and not (self.cell_pos[h:h + n] >= 0).any():
            self.head = h + n
            return h
        free = (self.cell_pos[:nc] < 0).astype(np.int32)
        c = np.concatenate([[0], np.cumsum(free)])
        hits = np.flatnonzero(c[n:] - c[:-n] == n)
        if hits.size == 0:
            raise RuntimeError("KV cache full")
        after = hits[hits >= h]
        base = int(after[0]) if after.size else int(hits[0])
        self.head = base + n
        return base

    def seq_cp(self, src_seq: int, dst_seq: int, p0: int = 0,
               p1: int | None = None):
        """O(1) logical fork: tag the source's cells with dst_seq too."""
        sel = ((self.cell_seq >> np.uint32(src_seq)) & 1).astype(bool)
        sel &= self.cell_pos >= p0
        if p1 is not None:
            sel &= self.cell_pos < p1
        self.cell_seq[sel] |= np.uint32(1 << dst_seq)

    def seq_rm(self, seq: int):
        """Remove a sequence's tag; free cells that belong to nobody."""
        self.cell_seq &= ~np.uint32(1 << seq)
        self.cell_pos[self.cell_seq == 0] = -1

    # -- requests -------------------------------------------------------------
    def add_request(self, prompt_tokens, n_predict: int, *, seed: int = 0,
                    top_k: int = 40, top_p: float = 0.9, temp: float = 0.8,
                    eos_id: int | None = None) -> int:
        """Queue a request; its seq id is the lowest one not in use (ids of
        finished requests are recycled, MAX_SEQ - 1 is the pad rows')."""
        used = {r.seq for r in self.requests.values() if not r.done}
        if len(used) >= MAX_SEQ - 1:
            raise RuntimeError(f"max {MAX_SEQ - 1} concurrent sequences")
        seq = next(s for s in range(MAX_SEQ - 1) if s not in used)
        rid = self._next_seq
        self._next_seq += 1
        self.requests[rid] = Request(
            seq=seq, prompt=list(map(int, prompt_tokens)),
            n_predict=n_predict, top_k=top_k, top_p=top_p, temp=temp,
            eos_id=eos_id, rng=np.random.default_rng(seed))
        return rid

    def fork(self, rid: int, *, seed: int = 1) -> int:
        """Fork a (fully prefilled) request into a new sequence sharing the
        prefix cells."""
        src = self.requests[rid]
        new = self.add_request([], src.n_predict, top_k=src.top_k,
                               top_p=src.top_p, temp=src.temp,
                               eos_id=src.eos_id, seed=seed)
        r = self.requests[new]
        r.pos = src.pos
        r.n_prompt_done = len(src.prompt)
        r.prompt = src.prompt
        r.logits = None if src.logits is None else src.logits.copy()
        r.next_tok = src.next_tok
        self.seq_cp(src.seq, r.seq)
        return new

    # -- device side -----------------------------------------------------------
    def _samp(self, nb: int, rows) -> np.ndarray:
        """(3, nb) f32 [temp; top_k; top_p] per ubatch row; rows: (row,
        request) pairs. Rows that sample nothing (pads) are greedy."""
        samp = np.zeros((3, nb), np.float32)
        samp[1] = 40.0
        samp[2] = 0.9
        for row, r in rows:
            samp[0, row] = max(0.0, r.temp)
            samp[1, row] = min(r.top_k, self._k_max)   # <= 0: the whole window
            samp[2, row] = r.top_p
        return samp

    def _upload(self, parts, samp=None):
        """ONE host-to-device copy of the int32 parts (and the sampling
        params as f32 bits); returns the parts on the card as int64, and
        the (3, nb) params as f32."""
        flat = [np.asarray(p, np.int32).reshape(-1) for p in parts]
        if samp is not None:
            flat.append(samp.reshape(-1).view(np.int32))
        dev = torch.from_numpy(np.concatenate(flat)).to(self.device)
        out, off = [], 0
        for p in flat[:len(parts)]:
            out.append(dev[off:off + p.size].long())
            off += p.size
        if samp is not None:
            out.append(dev[off:].view(torch.float32).reshape(3, -1))
        return out

    def _forward(self, tokens, positions, seqs, cells, cell_pos, cell_seq,
                 decode_only: bool):
        """One ubatch: (nb,) tokens/positions/seqs/cells and the (n_ctx,)
        registry on the card -> (nb, V) f32 logits."""
        mask = cells_attention_mask(positions[None], seqs[None],
                                    cell_pos[None], cell_seq[None])
        logits, self.cache = self.model.forward(
            self.cfg, self.params, tokens[None], positions[None], self.cache,
            0, compute_dtype=self.compute_dtype, cells=cells[None], mask=mask,
            cells_kernel=decode_only, fused_kv_update=self.fused_kv_update)
        return logits[0].float()

    def _pick(self, lg, samp, noise=None):
        """Token ids (nb,) on the card: greedy where temp <= 0, else drawn
        (Gumbel `noise` (nb, k_max) given, or drawn from the generator)."""
        temps, kks, pps = samp
        kw = dict(top_k=kks.long()[:, None], top_p=pps[:, None],
                  temp=temps[:, None])
        drawn = sample_device(lg, self._gen, k_max=self._k_max, **kw) \
            if noise is None else sample_gumbel(lg, noise, **kw)
        return torch.where(temps <= 0, lg.argmax(-1), drawn)

    # -- k-step decode chunks --------------------------------------------------
    def _chunk(self, k: int, nb: int):
        """(static tensors, CapturedStep) of a (k, nb) chunk."""
        if (k, nb) not in self._chunks:
            dev = self.device
            pin = dev.type == "cuda"
            ch = SimpleNamespace(
                k=k, nb=nb,
                packed=torch.zeros((6 + k) * nb + 2 * self.n_ctx,
                                   dtype=torch.int32, device=dev),
                u=torch.zeros((k, nb, self._k_max), device=dev),
                ids=torch.zeros((k, nb), dtype=torch.int64, device=dev),
                host=[torch.zeros((k, nb), dtype=torch.int64, pin_memory=pin)
                      for _ in range(2)],
                events=[None, None], slot=0)
            me = weakref.ref(self)
            self._chunks[(k, nb)] = (ch, CapturedStep(
                lambda: me()._run_chunk(ch), dev, self.graph_pool))
        return self._chunks[(k, nb)]

    def _run_chunk(self, ch):
        """k decode-only ubatches from ch.packed, [tok0|pos0|seqs|cells
        (k x nb)|cell_pos|cell_seq|samp (3 x nb) as f32 bits]: step i feeds
        the previous step's picks at pos0 + i into cells row i, its picks
        into ch.ids[i]. The registry holds all k steps' cells: step i cannot
        see the cells of later steps, their pos is past its tokens' pos."""
        k, nb, n_ctx, p = ch.k, ch.nb, self.n_ctx, ch.packed
        tok, pos0, seqs = (p[i * nb:(i + 1) * nb].long() for i in range(3))
        cells = p[3 * nb:(3 + k) * nb].long().reshape(k, nb)
        off = (3 + k) * nb
        cell_pos = p[off:off + n_ctx].long()
        cell_seq = p[off + n_ctx:off + 2 * n_ctx].long()
        samp = p[off + 2 * n_ctx:].view(torch.float32).reshape(3, nb)
        for i in range(k):
            lg = self._forward(tok, pos0 + i, seqs, cells[i], cell_pos,
                               cell_seq, decode_only=True)
            tok = self._pick(lg, samp, gumbel(ch.u[i]))
            ch.ids[i].copy_(tok)

    def _launch_chunk(self, k: int, nb: int, parts, samp, carry=None):
        """Upload the chunk's inputs (parts as _upload's, the first the
        tokens; `carry`, a (nb,) tensor on the card, replaces them: the
        previous chunk's last picks), draw its uniforms, run it, and start
        the copy of its ids to the host. Returns (chunk, slot) for
        `_fetch`; nothing here waits for the card."""
        ch, run = self._chunk(k, nb)
        flat = [np.asarray(q, np.int32).reshape(-1) for q in parts]
        self._staging(np.concatenate(flat + [samp.reshape(-1).view(np.int32)]),
                      ch.packed)
        if carry is not None:
            ch.packed[:nb].copy_(carry)
        torch.rand(ch.u.shape, generator=self._gen, device=self.device,
                   out=ch.u)
        run()
        self.n_ubatches["decode"] += k
        slot, ch.slot = ch.slot, ch.slot ^ 1
        if ch.events[slot] is not None:
            ch.events[slot].synchronize()    # the slot's last copy landed
        ch.host[slot].copy_(ch.ids, non_blocking=True)
        if self.device.type == "cuda":
            ch.events[slot] = torch.cuda.Event()
            ch.events[slot].record()
        return ch, slot

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        """Wait for a launched chunk's ids: (k, nb) int64 on the host."""
        ch, slot = handle
        if ch.events[slot] is not None:
            ch.events[slot].synchronize()
        return ch.host[slot].numpy().copy()

    # -- the step -------------------------------------------------------------
    def step(self) -> bool:
        """Assemble a ubatch (prompt chunks + one decode token per live seq),
        run it, sample. Returns False when all requests are done."""
        toks, poss, seqs, cells = [], [], [], []
        sample_rows: list[tuple[int, Request]] = []
        mixed = False                      # True if any prompt chunk joined

        for r in self.requests.values():
            if r.done:
                continue
            if r.n_prompt_done < len(r.prompt):
                room = self.n_ubatch - len(toks)
                if room <= 0:
                    continue
                chunk = r.prompt[r.n_prompt_done:r.n_prompt_done + room]
                base = self._find_slot(len(chunk))
                for i, t in enumerate(chunk):
                    self.cell_pos[base + i] = r.pos
                    self.cell_seq[base + i] = np.uint32(1 << r.seq)
                    toks.append(t)
                    poss.append(r.pos)
                    seqs.append(r.seq)
                    cells.append(base + i)
                    r.pos += 1
                r.n_prompt_done += len(chunk)
                mixed = True
                if r.n_prompt_done == len(r.prompt):
                    # prompt complete in this ubatch: its last row samples
                    sample_rows.append((len(toks) - 1, r))
            else:
                if len(toks) >= self.n_ubatch:
                    continue                 # ubatch full; decode next step
                if r.logits is None and r.next_tok is None:
                    r.done = True
                    continue
                tok = self._sample(r)
                r.out.append(tok)
                if ((r.eos_id is not None and tok == r.eos_id)
                        or len(r.out) >= r.n_predict or r.pos >= self.n_ctx - 1):
                    r.done = True
                    self.seq_rm(r.seq)
                    continue
                cell = self._find_slot(1)
                self.cell_pos[cell] = r.pos
                self.cell_seq[cell] = np.uint32(1 << r.seq)
                toks.append(tok)
                poss.append(r.pos)
                seqs.append(r.seq)
                cells.append(cell)
                r.pos += 1
                sample_rows.append((len(toks) - 1, r))

        if not toks:
            return any(not r.done for r in self.requests.values())

        n = len(toks)
        nb = min(_bucket(n), self.n_ctx)
        pad = nb - n
        # pad rows: the reserved seq id (fully masked) and the trash cell
        parts = [np.pad(toks, (0, pad)), np.pad(poss, (0, pad)),
                 np.pad(seqs, (0, pad), constant_values=MAX_SEQ - 1),
                 np.pad(cells, (0, pad), constant_values=self.trash_cell),
                 self.cell_pos, self.cell_seq.view(np.int32)]
        self.n_ubatches["mixed" if mixed else "decode"] += 1
        if self.on_device_sampling:
            *dev, samp = self._upload(parts, self._samp(nb, sample_rows))
            lg = self._forward(*dev, decode_only=not mixed)
            ids = self._pick(lg, samp).cpu().numpy()
            for row, r in sample_rows:
                r.next_tok = int(ids[row])
        else:
            lg = self._forward(*self._upload(parts),
                               decode_only=not mixed).cpu().numpy()
            for row, r in sample_rows:
                r.logits = lg[row]
        return any(not r.done for r in self.requests.values())

    def step_chunk(self, k: int) -> bool:
        """Up to k decode steps of every live request with one upload and
        one fetch of the (k, nb) sampled ids, then EOS and limits on the
        host. Matches k calls to step() on a decode-only ubatch; takes one
        step() when a live request is still prefilling (or on-device
        sampling is off), so it can be the whole serving loop's body.
        Tokens a request samples past its EOS or n_predict inside a chunk
        are discarded, and its cells freed with the sequence."""
        if k <= 1 or not self.on_device_sampling:
            return self.step()
        live = [r for r in self.requests.values() if not r.done]
        if not live:
            return False
        if any(r.n_prompt_done < len(r.prompt) or
               (r.next_tok is None and r.logits is None) for r in live):
            return self.step()          # a mixed or prefill ubatch
        k = min([k] + [self.n_ctx - 1 - r.pos for r in live])
        if k <= 1:
            return self.step()

        rows: list[Request] = []
        toks0, pos0, seqs, cells_rows = [], [], [], []
        for r in live:
            tok = self._sample(r)
            r.out.append(tok)
            if ((r.eos_id is not None and tok == r.eos_id)
                    or len(r.out) >= r.n_predict
                    or r.pos >= self.n_ctx - 1):
                r.done = True
                self.seq_rm(r.seq)
                continue
            cl = []
            for i in range(k):
                c = self._find_slot(1)
                self.cell_pos[c] = r.pos + i
                self.cell_seq[c] = np.uint32(1 << r.seq)
                cl.append(c)
            rows.append(r)
            toks0.append(tok)
            pos0.append(r.pos)
            seqs.append(r.seq)
            cells_rows.append(cl)
            r.pos += k
        if not rows:
            return any(not r.done for r in self.requests.values())

        n = len(rows)
        nb = min(_bucket(n), self.n_ctx)
        pad = nb - n
        cells_k = np.full((k, nb), self.trash_cell, np.int32)
        for row, cl in enumerate(cells_rows):
            cells_k[:, row] = cl
        parts = [np.pad(toks0, (0, pad)), np.pad(pos0, (0, pad)),
                 np.pad(seqs, (0, pad), constant_values=MAX_SEQ - 1),
                 cells_k, self.cell_pos, self.cell_seq.view(np.int32)]
        ids = self._fetch(self._launch_chunk(
            k, nb, parts, self._samp(nb, enumerate(rows))))      # (k, nb)
        for row, r in enumerate(rows):
            for i in range(k):
                tok = int(ids[i, row])
                if i == k - 1:
                    r.next_tok = tok     # sampled, not yet fed
                    break
                r.out.append(tok)
                # the ctx check per token: token i is fed at pos0 + i + 1
                if ((r.eos_id is not None and tok == r.eos_id)
                        or len(r.out) >= r.n_predict
                        or pos0[row] + i + 1 >= self.n_ctx - 1):
                    r.done = True
                    r.next_tok = None
                    self.seq_rm(r.seq)   # frees the unused chunk cells too
                    break
        return any(not r.done for r in self.requests.values())

    # -- double-buffered decode ----------------------------------------------
    def _dispatch_chunk(self, rows, tok, k: int):
        """Run one k-step decode chunk for `rows` and return its handle for
        `_fetch` without waiting for it. `tok` is a host list of first
        tokens (the pipeline head) or a (nb,) tensor on the card, the
        previous chunk's last picks: then no token crosses to the host.
        Registers the k cells of each row and advances r.pos."""
        n = len(rows)
        nb = min(_bucket(n), self.n_ctx)
        pad = nb - n
        cells_k = np.full((k, nb), self.trash_cell, np.int32)
        for row, r in enumerate(rows):
            for i in range(k):
                c = self._find_slot(1)
                self.cell_pos[c] = r.pos + i
                self.cell_seq[c] = np.uint32(1 << r.seq)
                cells_k[i, row] = c
        head = np.pad(tok, (0, pad)) if isinstance(tok, list) \
            else np.zeros(nb, np.int32)
        parts = [head, np.pad([r.pos for r in rows], (0, pad)),
                 np.pad([r.seq for r in rows], (0, pad),
                        constant_values=MAX_SEQ - 1),
                 cells_k, self.cell_pos, self.cell_seq.view(np.int32)]
        for r in rows:
            r.pos += k
        return self._launch_chunk(k, nb, parts,
                                  self._samp(nb, enumerate(rows)),
                                  carry=None if isinstance(tok, list) else tok)

    def run_pipelined(self, k: int) -> dict[int, list]:
        """Drive every request to the end with double-buffered k-step
        chunks: chunk j + 1 is run from chunk j's last picks on the card
        before the host reads chunk j's ids, so the fetch and the EOS and
        limit bookkeeping overlap chunk j + 1. Greedy tokens equal the
        step()/step_chunk loop's. A row that ends while a successor chunk
        is in flight has that chunk's tokens for it discarded (step_chunk's
        past-EOS discard, one chunk further) and its cells freed after the
        drain. Takes step() for prefill and mixed ubatches, so it can be
        the whole serving loop."""
        if not self.on_device_sampling:
            raise ValueError("run_pipelined needs on_device_sampling")
        while any(not r.done for r in self.requests.values()):
            live = [r for r in self.requests.values() if not r.done]
            if any(r.n_prompt_done < len(r.prompt)
                   or (r.next_tok is None and r.logits is None)
                   for r in live):
                self.step()
                continue
            kk = min([k] + [self.n_ctx - 1 - r.pos for r in live])
            if kk <= 1:
                self.step()
                continue
            # the pipeline head: each pending token consumed on the host,
            # as at step_chunk's chunk start
            rows, toks0 = [], []
            for r in live:
                tok = self._sample(r)
                r.out.append(tok)
                if ((r.eos_id is not None and tok == r.eos_id)
                        or len(r.out) >= r.n_predict
                        or r.pos >= self.n_ctx - 1):
                    r.done = True
                    self.seq_rm(r.seq)
                    continue
                rows.append(r)
                toks0.append(tok)
            if not rows:
                continue
            starts = [r.pos for r in rows]      # chunk-start positions
            inflight = self._dispatch_chunk(rows, toks0, kk)
            pending_rm: list[Request] = []
            while True:
                # a successor runs iff every row can take kk more tokens
                # past the chunk in flight without crossing its n_predict
                # or the arena (EOS is the one stop the host cannot see
                # coming) and no row ended at the last retire
                can_pipe = all(
                    not r.done
                    and len(r.out) + 2 * kk <= r.n_predict
                    and r.pos + kk <= self.n_ctx - 1 for r in rows)
                nxt = None
                if can_pipe:
                    nstarts = [r.pos for r in rows]
                    ch = inflight[0]
                    nxt = self._dispatch_chunk(rows, ch.ids[kk - 1], kk)
                ids = self._fetch(inflight)     # (kk, nb); nxt runs meanwhile
                for row, r in enumerate(rows):
                    if r.done:                  # ended: discard the chunk
                        continue
                    for i in range(kk):
                        tok = int(ids[i, row])
                        if i == kk - 1 and nxt is None:
                            # the pipeline drains: the last pick waits, as
                            # in step_chunk (sampled, not yet fed)
                            r.next_tok = tok
                            break
                        r.out.append(tok)
                        # the ctx check per token: token i is fed at
                        # starts[row] + i + 1 (r.pos is past the chunks in
                        # flight)
                        if ((r.eos_id is not None and tok == r.eos_id)
                                or len(r.out) >= r.n_predict
                                or starts[row] + i + 1 >= self.n_ctx - 1):
                            r.done = True
                            r.next_tok = None
                            if nxt is None:
                                self.seq_rm(r.seq)
                            else:
                                pending_rm.append(r)   # cells still in use
                            break
                if nxt is None:
                    break                       # the outer loop compacts
                inflight, starts = nxt, nstarts
            for r in pending_rm:
                self.seq_rm(r.seq)
        return {rid: r.out for rid, r in self.requests.items()}

    def _sample(self, r: Request) -> int:
        if self.on_device_sampling:
            tok = r.next_tok
            r.next_tok = None
            return tok
        if r.temp <= 0:
            return sample_greedy(r.logits)
        return sample_host(r.logits, top_k=r.top_k, top_p=r.top_p,
                           temp=r.temp, rng=r.rng)

    def run(self) -> dict[int, list]:
        while self.step():
            pass
        return {rid: r.out for rid, r in self.requests.items()}
