from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.ft.supervisor import (RestartsExhausted, Supervisor,
                                       run_with_restarts)

__all__ = ["RestartsExhausted", "StragglerMonitor", "Supervisor",
           "run_with_restarts"]
