from .client import TokenClient, TokenProtocolError
from .executor import ChipExecutor
from .hook import SharedChipGate, current_gate, install_gate

__all__ = [
    "TokenClient",
    "TokenProtocolError",
    "ChipExecutor",
    "SharedChipGate",
    "install_gate",
    "current_gate",
]
