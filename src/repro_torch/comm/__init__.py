"""Transport of the port: codecs, channel, scheduling, accounting.

Codecs (``codecs``), the channel model (``channel``), participation
schedulers (``scheduler``), per-round accounting (``metrics``),
error-feedback memory and its bounded population store (``feedback``),
``CommConfig``/``CommRound`` and the synchronous drivers
``CommSession``/``PopulationCommSession`` (``config``), the event-driven
``AsyncSession``/``PopulationAsyncSession`` (``async_driver``) and the
``Session`` protocol with ``make_session`` (``session``). Scenario
dynamics (``repro_torch.dynamics``) plug in through
``CommConfig(dynamics=...)``.
"""
from repro_torch.comm.async_driver import (
    MAX_RETRIES,
    AsyncSession,
    PopulationAsyncSession,
    make_staleness,
)
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
    PopulationCommSession,
    plan_bytes,
)
from repro_torch.comm.feedback import (
    EF_VARIANTS,
    BoundedMemory,
    compensate,
    init_memory,
    residual_norms,
)
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
