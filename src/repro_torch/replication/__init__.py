"""Replication plane. Only its configuration is ported yet."""
from .types import ReplicationConfig

__all__ = ["ReplicationConfig"]
