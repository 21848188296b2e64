"""Deep-net optimizers (the convex federated optimizers live in
``core``): AdamW, its schedules, and the FLeNS head."""
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.flens_head import (
    extract_features,
    flens_head_init,
    flens_head_update,
    head_problem,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine
