"""Continuous-batching serving engine over the port's model API.

    from repro_torch import configs
    from repro_torch.serving import Engine, Request, SamplingParams

    cfg = configs.get_config("tinyllama-1.1b", mult="trunc2x2",
                             kernel_policy="pallas", attn_impl="flash",
                             dtype="float32")
    eng = Engine(cfg, capacity=4, max_len=256, prefill_buckets=(128,))
    eng.submit(Request("a", [1, 2, 3], SamplingParams(max_new_tokens=8)))
    for done in eng.run_until_complete():
        print(done.request_id, done.tokens, done.finish_reason)

`PagedEngine` takes the same arguments plus the paged ones (page_size,
n_pages, prefill_chunk, chunk_budget, draft_tier, spec_k, prefix_cache)
and emits the slot engine's tokens.  The engines run on the CUDA device;
pass `device="cpu"` to run the plain PyTorch versions on the CPU.
"""

from repro_torch.serving.engine import Engine  # noqa: F401
from repro_torch.serving.paged import PagedEngine  # noqa: F401
from repro_torch.serving.paging import (  # noqa: F401
    PageAllocator, PagingError,
)
from repro_torch.serving.types import (  # noqa: F401
    Completion, Request, SamplingParams, SpecStats,
)
