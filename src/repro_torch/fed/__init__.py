from repro_torch.fed.clients import (PARTICIPATION_KINDS, ClientPool,
                                     ClientState, ParticipationSchedule,
                                     counter_uniform, make_pool)

__all__ = ["ClientPool", "ClientState", "ParticipationSchedule",
           "PARTICIPATION_KINDS", "counter_uniform", "make_pool"]
