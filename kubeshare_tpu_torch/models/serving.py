"""Continuous-batching decode server: slot-based admission over one
fixed-shape decode batch (port of ``kubeshare_tpu/models/serving.py``).

A fixed pool of S batch slots, per-slot cache lengths
(``init_kv_cache(per_slot=True)``), prompt admission by single-slot
prefill (``prefill_slot``) padded to a prompt bucket, retirement by
length reset (``retire_slot``): an idle slot costs its masked lane of
the batched matmuls. The cache is updated in place (models/llama.py).

Correctness invariants (tests/test_torch_serving.py):
- a slot's logits equal decoding that sequence alone with a scalar
  cache, whatever the other slots do;
- prompts padded up to a bucket leave no trace: padding keys sit at
  ring slots the position mask can only reach after decode has
  overwritten them with real keys;
- a retired slot's history can never leak into the next tenant
  (length 0 re-masks every ring position).

The decode step reads and writes fixed buffers: the tokens fed in
(each step's successors are written back into them), the active mask
and the cache, all updated in place. On a CUDA model (``cuda_graph``,
the default) the first ``step`` captures that step as a CUDA graph
(``models/graph.py``) and every step replays it: the counterpart of the
reference's jitted ``_one``. The host's tokens and mask reach the
device through a pinned staging buffer. On a CPU model, or with
``cuda_graph=False``, the same step runs eager.

``step_burst(quantum)`` runs ``quantum`` decode steps with the tokens
kept on the device and syncs with the host once at the end (the
reference's one ``lax.scan`` call). It replays the one-step graph
``quantum`` times, each step's tokens copied into a [quantum, S]
buffer, where the reference compiles one program per quantum.

The server records its own spans in ``trace`` (``utils/trace.py``):
``serve.admit`` around each ``admit`` (field ``tokens``, the prompt's
length), ``serve.burst`` around each ``step_burst`` (field ``steps``,
the decode steps run) and ``serve.sync`` around each host wait for the
device inside them. A parent's time less its ``serve.sync`` children is
the host's time launching its work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.trace import SpanLog
from .graph import Replay, restoring
from .llama import (
    Llama, _sample_token, cache_slots, init_kv_cache, llama_apply_cached,
    prefill_slot, retire_slot,
)

# admit_reason() refusal codes: the same strings as the reference's
# request plane uses for its shed reasons. Pool-full is "retry later",
# oversized is "never".
REFUSE_POOL_FULL = "pool-full"
REFUSE_OVERSIZED = "oversized-prompt"


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket "
                     f"{max(buckets)}")


class DecodeServer:
    """S-slot continuous-batching decoder for one llama model, on the
    model's device.

    ``admit(prompt) -> (slot, first_token) | None`` (None = cannot admit),
    ``step() -> {slot: token}`` decodes every active slot one token,
    ``retire`` / auto-retire on ``eos_id`` or ``max_new`` frees slots for
    the next admission. Sampling draws from a ``torch.Generator`` seeded
    with ``seed``. ``decode_step`` is one decode step on the server's
    fixed buffers, a CUDA graph on a CUDA model with ``cuda_graph``
    (module docstring); ``logits`` holds the last step's float32 logits
    [S, vocab]."""

    def __init__(
        self,
        model: Llama,
        slots: int = 8,
        prompt_buckets: Sequence[int] = (32, 128, 512),
        temperature: float = 0.0,
        top_k: int = 0,
        eos_id: Optional[int] = None,
        max_new: int = 0,
        seed: int = 0,
        cuda_graph: bool = True,
    ):
        cfg = model.cfg
        # a bucket must fit BOTH the context horizon (one generated
        # token has to follow the prompt) and a single prefill write
        # into the ring
        cap = min(cfg.max_seq_len - 1, cache_slots(cfg))
        buckets = sorted(b for b in prompt_buckets if b <= cap)
        if not buckets:
            raise ValueError(
                f"no prompt bucket fits (cap {cap}: max_seq_len-1 and "
                "the cache ring)"
            )
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.slots = slots
        self.buckets = tuple(buckets)
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.max_new = max_new
        self.cache = init_kv_cache(cfg, slots, per_slot=True,
                                   device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.active: List[bool] = [False] * slots
        self.last_tok: List[int] = [0] * slots
        self.generated: List[int] = [0] * slots
        # host-side mirror of cache["length"]: every transition is
        # host-initiated (admit: true_len; step: +1 per active slot;
        # retire: 0), so stop rules never wait on the device
        self.host_len: List[int] = [0] * slots
        self.trace = SpanLog()
        # the decode step's fixed inputs, and their host staging
        self._tokens = torch.zeros(slots, dtype=torch.int64,
                                   device=self.device)
        self._active = torch.zeros(slots, dtype=torch.bool,
                                   device=self.device)
        cuda = self.device.type == "cuda"
        self._staged = tuple(
            torch.zeros(slots, dtype=t.dtype, pin_memory=cuda)
            for t in (self._tokens, self._active))
        # the warm-up's K/V writes land at each lane's length, where the
        # first replay writes before anything reads them; it draws from
        # a generator of its own
        decode, generator = self._decoder(), self.generator
        self.decode_step = Replay(
            lambda: decode(generator),
            restoring(lambda: decode(torch.Generator(
                device=model.device).manual_seed(0)),
                [self.cache["length"], self._tokens]),
            [generator] if temperature > 0 else [],
            graphed=cuda and cuda_graph)

    @property
    def logits(self) -> Optional[torch.Tensor]:
        """The last decode step's float32 logits [S, vocab]."""
        return self.decode_step.output

    def _decoder(self):
        """``decode(generator)``: one decode step on the fixed buffers.
        It feeds ``_tokens``, writes each active lane's successor back
        into them (idle lanes 0) and returns the step's [S, vocab]
        logits. It holds the buffers, not the server, so that the
        server is freed as soon as it is dropped."""
        model, cache, tokens, active = (self.model, self.cache,
                                        self._tokens, self._active)
        temperature, top_k = self.temperature, self.top_k

        def decode(generator: torch.Generator) -> torch.Tensor:
            logits, _ = llama_apply_cached(model, tokens[:, None], cache)
            logits = logits[:, -1]
            nxt = _sample_token(logits, generator, temperature, top_k)
            # an idle lane must stay idle: its length snaps back to 0 so
            # its garbage write never becomes visible history
            cache["length"].masked_fill_(~active, 0)
            tokens.copy_(torch.where(active, nxt, 0))
            return logits

        return decode

    def _load_inputs(self) -> None:
        """The host's last tokens and active mask into the step's input
        buffers. The staging buffers are pinned on a CUDA model, so the
        copies do not wait; every step ends in a host sync before the
        staging is written again."""
        for staged, host, dev in zip(self._staged,
                                     (self.last_tok, self.active),
                                     (self._tokens, self._active)):
            staged.copy_(torch.tensor(host, dtype=staged.dtype))
            dev.copy_(staged, non_blocking=True)

    # ---- admission / retirement ---------------------------------

    def free_slots(self) -> int:
        return self.active.count(False)

    def can_admit(self) -> bool:
        """True when a slot is free right now (no device work)."""
        return False in self.active

    def admit_reason(self, prompt_len: int) -> Optional[str]:
        """Why ``admit`` would refuse a prompt of ``prompt_len`` tokens,
        without device work: ``None`` = admit takes it now;
        :data:`REFUSE_OVERSIZED` = never (larger than the largest
        bucket); :data:`REFUSE_POOL_FULL` = retry after a retirement.
        A non-positive length is a caller bug."""
        if prompt_len <= 0:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        if prompt_len > self.buckets[-1]:
            return REFUSE_OVERSIZED
        if False not in self.active:
            return REFUSE_POOL_FULL
        return None

    def admit(self, prompt: Sequence[int]):
        """Prefill ``prompt`` into a free slot. Returns ``(slot,
        first_token)`` (the first generated token), or ``None`` when the
        pool is full or the prompt exceeds the largest bucket
        (``admit_reason`` tells the two apart). An empty prompt raises
        ValueError."""
        with self.trace.span("serve.admit", tokens=len(prompt)):
            return self._admit(prompt)

    def _admit(self, prompt: Sequence[int]):
        if not prompt:
            raise ValueError("empty prompt")
        true_len = len(prompt)
        if true_len > self.buckets[-1]:
            return None
        try:
            slot = self.active.index(False)
        except ValueError:
            return None
        bucket = _bucket(true_len, self.buckets)
        padded = list(prompt) + [0] * (bucket - true_len)
        tokens = torch.tensor([padded], dtype=torch.int64, device=self.device)
        logits, self.cache = prefill_slot(self.model, tokens, self.cache,
                                          slot)
        # rewind the padding: with length = true_len the mask can only
        # see the pad keys after decode has overwritten each of them
        self.cache["length"][slot] = true_len
        with self.trace.span("serve.sync"):
            first = int(_sample_token(logits[:, true_len - 1],
                                      self.generator, self.temperature,
                                      self.top_k)[0])
        self.active[slot] = True
        self.last_tok[slot] = first
        self.generated[slot] = 1
        self.host_len[slot] = true_len
        # the FIRST token obeys the same stop rules as any step token
        if ((self.eos_id is not None and first == self.eos_id)
                or (self.max_new and self.generated[slot] >= self.max_new)):
            self.retire(slot)
        return slot, first

    def retire(self, slot: int) -> None:
        self.cache = retire_slot(self.cache, slot)
        self.active[slot] = False
        self.last_tok[slot] = 0
        self.generated[slot] = 0
        self.host_len[slot] = 0

    # ---- decode ---------------------------------------------------

    def step(self) -> Dict[int, int]:
        """One decode step across every active slot: each slot's most
        recent token is fed in and its successor comes back as
        {slot: token}. Auto-retires slots that hit eos_id / max_new /
        the cache horizon (the eos token itself is reported)."""
        if not any(self.active):
            return {}
        self._load_inputs()
        self.decode_step()
        with self.trace.span("serve.sync"):
            nxt = self._tokens.tolist()
        out: Dict[int, int] = {}
        for s in range(self.slots):
            if not self.active[s]:
                continue
            tok = nxt[s]
            out[s] = tok
            self.last_tok[s] = tok
            self.generated[s] += 1
            self.host_len[s] += 1  # mirrors the device-side length
            hit_eos = self.eos_id is not None and tok == self.eos_id
            hit_max = self.max_new and self.generated[s] >= self.max_new
            # the NEXT decode would write position ``length``, past the
            # horizon once length >= max_seq_len
            hit_cap = self.host_len[s] >= self.cfg.max_seq_len
            if hit_eos or hit_max or hit_cap:
                self.retire(s)
        return out

    def step_burst(self, quantum: int) -> Dict[int, List[int]]:
        """Decode up to ``quantum`` tokens per active slot with one host
        sync; returns {slot: tokens}, each stream cut by its stop rules
        (tokens produced past eos / max_new are discarded). Falls back
        to single steps when an active slot is within ``quantum`` of the
        context horizon."""
        with self.trace.span("serve.burst") as span:
            out, span.fields["steps"] = self._burst(quantum)
        return out

    def _burst(self, quantum: int) -> Tuple[Dict[int, List[int]], int]:
        """``step_burst``'s tokens and the decode steps it ran."""
        if not any(self.active):
            return {}, 0
        if quantum <= 1:
            return {s: [t] for s, t in self.step().items()}, 1
        if any(self.host_len[s] + quantum > self.cfg.max_seq_len
               for s in range(self.slots) if self.active[s]):
            out: Dict[int, List[int]] = {}
            steps = 0
            while steps < quantum and any(self.active):
                for s, t in self.step().items():
                    out.setdefault(s, []).append(t)
                steps += 1
            return out, steps
        self._load_inputs()
        seq = torch.empty(quantum, self.slots, dtype=torch.int64,
                          device=self.device)
        for i in range(quantum):
            self.decode_step()
            seq[i].copy_(self._tokens)
        with self.trace.span("serve.sync"):
            seq = seq.tolist()  # [quantum, S]: the one host sync
        out = {}
        for s in range(self.slots):
            if not self.active[s]:
                continue
            self.host_len[s] += quantum  # the device wrote every sub-step
            kept: List[int] = []
            stop = False
            for step_tokens in seq:
                tok = step_tokens[s]
                kept.append(tok)
                self.generated[s] += 1
                if ((self.eos_id is not None and tok == self.eos_id)
                        or (self.max_new
                            and self.generated[s] >= self.max_new)):
                    stop = True
                    break
            out[s] = kept
            if stop or self.host_len[s] >= self.cfg.max_seq_len:
                self.retire(s)
            else:
                self.last_tok[s] = kept[-1]
        return out, quantum
