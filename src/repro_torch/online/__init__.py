"""Online adaptation plane. Only the migration parameters are ported yet."""
from .migration import MigrationConfig

__all__ = ["MigrationConfig"]
