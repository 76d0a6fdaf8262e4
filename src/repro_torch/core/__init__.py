# The pilot runtime of the port (mirror of ``repro.core``).
#
# The user-facing entry point is the Session facade + stage-graph DSL;
# the layered runtime underneath (PilotManager -> Pilot -> RemoteAgent
# -> Transport) stays importable from its own modules.
from repro_torch.core.session import (KindAwarePlacement, PlacementPolicy,
                                      ServiceHandle, Session, StageContext,
                                      StageGraph, StageSpec, stage)

__all__ = [
    "Session", "ServiceHandle", "stage", "StageContext", "StageSpec",
    "StageGraph", "PlacementPolicy", "KindAwarePlacement",
]
