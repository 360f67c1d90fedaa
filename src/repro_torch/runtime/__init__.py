from .fault import ElasticController, FailureEvent
from .straggler import StragglerPolicy

__all__ = ["ElasticController", "FailureEvent", "StragglerPolicy"]
