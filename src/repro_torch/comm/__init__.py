"""Transport of the port: the synchronous driver on a dense client axis.

Codecs (``codecs``), the channel model (``channel``), participation
schedulers (``scheduler``), per-round accounting (``metrics``),
error-feedback memory (``feedback``), ``CommConfig``/``CommRound``/
``CommSession`` (``config``) and the ``Session`` protocol with the
no-transport ``NullSession`` (``session``). The asynchronous driver,
populations and scenario dynamics come with later slices.
"""
from repro_torch.comm.channel import ChannelDraw, ChannelModel
from repro_torch.comm.codecs import (
    CODEC_SPECS,
    CastCodec,
    Codec,
    IdentityCodec,
    QInt8Codec,
    SymPackCodec,
    TopKCodec,
    make_codec,
)
from repro_torch.comm.config import (
    NULL_COMM,
    CommConfig,
    CommRound,
    CommSession,
    plan_bytes,
)
from repro_torch.comm.feedback import EF_VARIANTS
from repro_torch.comm.metrics import (
    RoundTrace,
    Transport,
    cumulative_bytes,
    cumulative_bytes_down,
    cumulative_bytes_up,
    cumulative_time,
    summarize,
    transport_from_traces,
)
from repro_torch.comm.scheduler import (
    SCHEDULER_SPECS,
    BandwidthAware,
    FullParticipation,
    Scheduler,
    UniformSampler,
    make_scheduler,
)
from repro_torch.comm.session import NullSession, Session, make_session
