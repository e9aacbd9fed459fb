from .attention import (
    attention, flash_attention, flash_attention_reference,
    flash_attention_with_lse, mha,
)

__all__ = [
    "attention", "flash_attention", "flash_attention_reference",
    "flash_attention_with_lse", "mha",
]
