"""The per-device config-file contract the native isolation runtime
reads, and the daemon that writes it (copies of what
``kubeshare_tpu/nodeconfig`` defines)."""

from .daemon import NodeConfigDaemon
from .files import (
    ConfigEntry,
    PortEntry,
    list_chip_files,
    read_config_file,
    read_port_file,
    write_config_file,
    write_port_file,
)

__all__ = [
    "ConfigEntry",
    "PortEntry",
    "list_chip_files",
    "read_config_file",
    "read_port_file",
    "write_config_file",
    "write_port_file",
    "NodeConfigDaemon",
]
