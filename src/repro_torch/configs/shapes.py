"""The four input shapes (a copy of the JAX package's ``configs/shapes.py``).

Each shape names a workload kind; the dry-run decides which step function to
lower from ``kind``:

  * ``train``           -> ``train_step``  (tokens + labels, full batch)
  * ``prefill``         -> ``prefill_step`` (tokens, builds the KV cache)
  * ``decode``          -> ``serve_step``  (ONE new token against a KV cache
                                            of ``seq_len`` past positions)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = InputShape("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown input shape {name!r}; options: {sorted(SHAPES)}") from None
