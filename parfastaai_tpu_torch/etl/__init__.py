from .database import PresenceData, QueryTargetDatabase, SCPDatabase

__all__ = ["PresenceData", "QueryTargetDatabase", "SCPDatabase"]
