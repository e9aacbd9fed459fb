"""Seeds for everything a run draws: each part of a model (a family's
embedding, blocks and head; ``families/<family>.py`` draws them), each
pod's rows and requests and the check's sample get a generator of their
own, seeded from the run's ``--seed``, the pod and the part, so a part
can be drawn again alone, as the reference does layer by layer once the
program's state is freed.

Imports only ``torch``: the reference draws through it too.
"""

from __future__ import annotations

import hashlib

import torch


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit seed for ``parts`` of a run with ``seed``."""
    key = ":".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, *parts))
    return g
