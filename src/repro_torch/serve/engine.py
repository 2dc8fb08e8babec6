"""Batched serving engine of the port (`repro.serve.engine`):
continuous-batching-lite over the decode step.

Requests join a waiting queue; at each engine tick, finished slots are
retired, waiting requests are prefilled into free slots (one shared
fixed-shape KV cache, slot = batch row), and one `decode_step` advances
every active slot by one token.  Slot state is managed host-side; the
device sees fixed shapes only.

As in the reference, every slot decodes at one uniform position, the
maximum over the live slots.  Every prefill goes through the flash
attention wrapper (the reference's `prefill(use_flash=True)`, which its
engine leaves at the default): a CUDA tensor launches the kernel, a CPU
tensor runs its plain version.  It is the path that serves every prompt
length, since `sdpa_ref` refuses a prompt longer than 2048 tokens that
is not a multiple of 2048.  Mamba and RWKV6 layers keep their states in
the same shared cache; their prefill runs the selective-scan and WKV
kernels on the card, and decode the selective scan at T = 1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, batch_slots: int = 4,
                 max_len: int = 512, sampler: Callable | None = None,
                 dtype=torch.float32, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.dtype = dtype
        self.sampler = sampler or (lambda logits, k: logits.argmax(-1))
        self.cache = TF.init_cache(cfg, batch_slots, max_len, dtype,
                                   self.device)
        self.active: list[Request | None] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int32)
        self.waiting: list[Request] = []
        self._retired: list[Request] = []

    # ---------------------------------------------------------------- admin
    def submit(self, req: Request):
        """Queue a request.  Oversized prompts are rejected HERE, before
        they join the queue — failing later, mid-tick, would abort
        service for every other active slot (`_prefill_into` keeps the
        same check as a backstop for direct callers)."""
        self._check_fits(req)
        self.waiting.append(req)

    def _check_fits(self, req: Request):
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"does not fit the shared KV cache (max_len="
                f"{self.max_len} incl. one decode slot); raise max_len "
                "or truncate the prompt")

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is None and self.waiting:
                req = self.waiting.pop(0)
                self._prefill_into(slot, req)

    def _prefill_into(self, slot: int, req: Request):
        """Prefill a single request and splice its cache into the shared
        batch cache at `slot`, in place.  Rejects prompts that do not fit
        the shared cache (see `submit`)."""
        self._check_fits(req)
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None, :]
        logits, cache1 = self._prefill(tokens)
        req.out.append(int(self.sampler(logits, 1)[0]))
        for name, leaves in self.cache.items():
            for leaf, shared in leaves.items():
                # K/V: shared [R, slots, S, ...], single [R, 1, S' <= S,
                # ...]; SSM states ([R, 1, d_conv-1, di], [R, 1, di, ds],
                # [R, 1, 1, d], [R, 1, H, D, D]) match dim 2: no pad
                single = cache1[name][leaf]
                pad = shared.shape[2] - single.shape[2]
                if pad:
                    single = torch.nn.functional.pad(single,
                                                     (0, 0, 0, 0, 0, pad))
                shared[:, slot:slot + 1].copy_(single)
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)

    def _prefill(self, tokens: torch.Tensor):
        return TF.prefill(self.params, tokens, self.cfg,
                          max_len=self.max_len, use_flash=True,
                          dtype=self.dtype)

    def _decode(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        logits, self.cache = TF.decode_step(self.params, self.cache, tokens,
                                            pos, self.cfg, dtype=self.dtype)
        return logits

    # ----------------------------------------------------------------- tick
    def step(self) -> int:
        """One engine tick: admit + decode one token for every active
        slot.  Returns number of active requests."""
        self._admit()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0
        # uniform decode position: the engine advances the max position;
        # per-slot last tokens are gathered host-side
        last = np.zeros((self.slots, 1), np.int64)
        for s in live:
            last[s, 0] = self.active[s].out[-1]
        logits = self._decode(torch.as_tensor(last, device=self.device),
                              int(self.pos[live].max()))
        nxt = self.sampler(logits, 1).cpu().numpy()
        for s in live:
            req = self.active[s]
            req.out.append(int(nxt[s]))
            self.pos[s] += 1
            if (len(req.out) >= req.max_new_tokens
                    or self.pos[s] >= self.max_len - 1):
                req.done = True
                self.active[s] = None
                self._retired.append(req)
        return len(live)

    def drain_retired(self) -> list[Request]:
        """Hand back (and forget) every request retired since the last
        drain.  Callers driving `step()` directly should drain
        periodically so the retired list does not grow without bound."""
        finished, self._retired = self._retired, []
        return finished

    def run_until_drained(self, max_ticks: int = 1000) -> list[Request]:
        """Tick until every submitted request retires (or max_ticks);
        returns all retired requests not yet drained — including any
        finished by earlier manual `step()` calls."""
        for _ in range(max_ticks):
            if not self.waiting and all(a is None for a in self.active):
                break
            self.step()
        return self.drain_retired()
