"""Serving runtime of the port: paged KV cache, continuous-batching
scheduler and engine, seeded load, the streaming HTTP front door and
the replica fleet's router (counterpart of ``paddle_tpu/serving``).

    from paddle_tpu_torch.serving import ServingEngine, ServeConfig
    eng = ServingEngine(model, ServeConfig(max_slots=64))
    eng.submit(prompt_ids, max_new_tokens=64)
    report = eng.run()

The door and the router live in ``serving.frontend`` and
``serving.router``, as in the reference.
"""
from .engine import DecodeAuditLayer, ServeConfig, ServingEngine, request_seed
from .kv_cache import PagedCacheView, PagedKVCache, TRASH_BLOCK, blocks_for
from .loadgen import poisson_requests
from .scheduler import (ContinuousBatchingScheduler, DecodePlan,
                        RejectReason, RejectedRequest, Request)

__all__ = ['ServeConfig', 'ServingEngine', 'DecodeAuditLayer',
           'request_seed', 'PagedCacheView', 'PagedKVCache', 'TRASH_BLOCK',
           'blocks_for', 'poisson_requests', 'ContinuousBatchingScheduler',
           'DecodePlan', 'RejectReason', 'RejectedRequest', 'Request']
