from .elastic import (FailureInjector, SimulatedFailure,  # noqa: F401
                      StragglerMonitor)
