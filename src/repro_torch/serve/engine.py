"""Batched serving: prefill + one-token decode steps and a slot-based
continuous-batching engine (counterpart of repro/serve/engine.py).

The decode step is the paper's workload reborn: one token streams every
weight of the stack and each slot's whole KV ring (or, in an SSD stack,
its recurrent state) — about one flop a byte, the bandwidth-bound regime
the analytical model provisions for. With attn_impl="flash" the attention
runs on the hand-written kernels (flash prefill, split-K decode over the
ring); an SSD stack's prefill runs the SSD chunk-scan kernel in every
layer, and its decode step is plain tensor work; the RG-LRU recurrence,
the projections, the MLP, the experts and the head are plain tensor work
and matrix products.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.attention import INF_POS
from repro_torch.models.common import dtype_of


def bucket_len(n: int, lo: int = 8) -> int:
    """Next power of two >= n (floored at lo): prompts are padded to a few
    lengths, as the reference pads them so it compiles once a bucket."""
    b = lo
    while b < n:
        b *= 2
    return b


def make_prefill_step(cfg):
    """(params, inputs, caches) -> (last-position logits, new_caches). The
    head is applied to the last hidden state only."""

    def step(params, inputs, caches):
        hidden, new_caches, _ = lm.prefill(params, cfg, inputs, caches,
                                           return_hidden=True)
        return lm.head_logits(params, cfg, hidden[:, -1:])[:, 0], new_caches

    return step


def make_serve_step(cfg, sample: str = "greedy", temperature: float = 1.0):
    """(params, tokens (B,1) | embeds (B,1,D), cache_len (B,), caches,
    generator) -> (next_token (B,) int32, logits (B,V) fp32, new_caches).

    "greedy" takes the first maximum, as jnp.argmax does. Any other
    `sample` draws from softmax(logits / temperature) on the explicit
    torch.Generator; the reference draws with jax.random.categorical, so
    the two agree in distribution, not in bits."""

    def step(params, inputs, cache_len, caches, generator):
        logits, new_caches, _ = lm.decode_step(params, cfg, inputs,
                                               cache_len, caches)
        logits = logits[:, -1].float()
        if sample == "greedy":
            nxt = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return nxt.to(torch.int32), logits, new_caches

    return step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 32
    generated: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Slot-based continuous batching.

    Fixed B decode slots with per-slot cache_len; a finished slot is
    refilled by prefilling the new request's prompt in a 1-row cache and
    copying that row, every tensor of it (pos planes, the SSD and RG-LRU
    blocks' recurrent and conv states) over the slot's row of the batch
    cache. Slot and length bookkeeping
    lives in a host-side numpy mirror, so the only device sync of a decode
    step is the sampled tokens. Prompts are padded to power-of-two
    buckets (attention-only stacks: padded ring slots are re-marked
    never-written via the pos plane); a stack with SSD blocks prefills the
    raw prompt, which must be shorter than a chunk or a whole number of
    chunks (models.ssm._ssd_chunked asserts it, as the reference does).
    A bucketed stack's MoE blocks route the pad tokens too, after the
    prompt's, so their capacity comes from the padded length, as in the
    reference.

    `params` is an LM module; the engine runs on its device, which must be
    `device` (the card unless device="cpu").
    """

    def __init__(self, cfg, params, *, batch_slots: int = 4,
                 max_len: int = 512, seed: int = 0, device=None):
        assert cfg.input_mode == "tokens", "engine drives token models"
        self.device = resolve_device(device)
        have = params.final_norm.device
        if have.type != self.device.type or (
                have.index is not None and self.device.index is not None
                and have.index != self.device.index):
            raise ValueError(f"the model lives on {have}, the engine runs "
                             f"on {self.device}")
        self.cfg, self.params = cfg, params
        self.B, self.max_len = batch_slots, max_len
        self.caches = lm.init_caches(cfg, batch_slots, max_len,
                                     dtype_of(cfg.dtype), self.device)
        # host-side mirror: authoritative, device copy derives from it
        self.cache_len = np.zeros((batch_slots,), np.int32)
        self.slots: list[Request | None] = [None] * batch_slots
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._serve = make_serve_step(cfg)
        # recurrent (ssd/rglru) states carry real content at padded steps,
        # so only pure-attention stacks can bucket prompt lengths
        self._bucket = all(k == "attn" for k in cfg.block_pattern)

    # --- row-isolated prefill + insertion ---------------------------------
    def _prefill_row(self, tokens, length: int):
        """(padded,) tokens -> (logits at position length - 1, 1-row
        caches). The head runs on that one position only."""
        caches1 = lm.init_caches(self.cfg, 1, self.max_len,
                                 dtype_of(self.cfg.dtype), self.device)
        hidden, caches1, _ = lm.prefill(self.params, self.cfg, tokens[None],
                                        caches1, return_hidden=True)
        if tokens.shape[0] > length:
            # padded bucket: ring slots written by pad tokens revert to
            # never-written
            for c in caches1:
                if "pos" in c:
                    c["pos"][:, length:] = INF_POS
        last = lm.head_logits(self.params, self.cfg,
                              hidden[:, length - 1:length])[0, 0]
        return last, caches1

    def _insert_row(self, row_caches, slot: int) -> None:
        # the whole row, pos planes and recurrent states included: a
        # refilled slot must not see the previous request's positions or
        # state
        for c, r in zip(self.caches, row_caches):
            for name, t in r.items():
                c[name][slot] = t[0]

    @torch.no_grad()
    def submit(self, req: Request) -> bool:
        for i, s in enumerate(self.slots):
            if s is None:
                n = len(req.prompt)
                # never pad past the ring: pad positions would wrap and
                # evict real prompt K/V that the pos reset (slot-indexed)
                # cannot revert
                padded = (min(bucket_len(n), self.max_len)
                          if self._bucket and n <= self.max_len else n)
                prompt = np.zeros((padded,), np.int32)
                prompt[:n] = np.asarray(req.prompt, np.int32)
                logits, row = self._prefill_row(
                    torch.from_numpy(prompt).to(self.device), n)
                # the slot is taken once the prefill went through: a
                # prompt the model refuses leaves it free
                self.slots[i] = req
                self._insert_row(row, i)
                self.cache_len[i] = n
                req.generated.append(int(torch.argmax(logits)))
                return True
        return False

    @torch.no_grad()
    def step(self):
        """One decode step for all active slots."""
        active = [i for i, s in enumerate(self.slots) if s is not None
                  and not s.done]
        finished = []
        for i in list(active):
            r = self.slots[i]
            if len(r.generated) >= r.max_new_tokens \
                    or self.cache_len[i] >= self.max_len - 1:
                r.done = True
                finished.append(r)
                self.slots[i] = None
                active.remove(i)
        if not active:
            return finished
        last = np.zeros((self.B, 1), np.int32)
        for i in active:
            last[i, 0] = self.slots[i].generated[-1]
        # inactive slots run the step too and write their ring, as in the
        # reference; a refill replaces the whole row
        nxt, _, self.caches = self._serve(
            self.params, torch.from_numpy(last).to(self.device),
            torch.from_numpy(self.cache_len.copy()).to(self.device),
            self.caches, self.generator)
        for i in active:
            self.cache_len[i] += 1
        nxt = nxt.cpu().numpy()            # the step's one device sync
        for i in active:
            self.slots[i].generated.append(int(nxt[i]))
        return finished

    def run(self, requests):
        """Drive a list of requests to completion; returns them."""
        queue = deque(requests)
        done = []
        while queue or any(s is not None for s in self.slots):
            while queue and self.submit(queue[0]):
                queue.popleft()
            done.extend(self.step())
        return done
