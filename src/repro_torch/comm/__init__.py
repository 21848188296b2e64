"""Transport of the port. This slice carries only the no-transport path
(``comm=None``): the no-op ``NULL_COMM`` view, the ``NullSession``
session that bills the identity-codec byte plan, and ``Transport``."""
from repro_torch.comm.config import NULL_COMM
from repro_torch.comm.metrics import Transport
from repro_torch.comm.session import NullSession, Session, make_session
