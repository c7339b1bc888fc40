from .fleet_util import FleetUtil  # noqa: F401
