"""Serving — counterpart of ``repro/serve/``: the LM decode loop
(``ContinuousBatcher``, ``serve_prefill_step`` / ``serve_decode_step``)
and the multi-tenant secure tier it drives: ``SessionPool`` /
``HEProgramCache`` (``sessions.py``), ``CrossRequestHEBatcher``
(``he_batcher.py``) and ``build_secure_serving`` (``engine.py``)."""
from repro_torch.serve.engine import (ContinuousBatcher, SecureServing,
                                      ServeConfig, build_secure_linears,
                                      build_secure_serving,
                                      serve_decode_step, serve_prefill_step)
from repro_torch.serve.he_batcher import (CrossRequestHEBatcher, SecureCall,
                                          StepStats)
from repro_torch.serve.sessions import (HEProgramCache, SessionPool,
                                        SessionStats, TenantSession)

__all__ = ["ContinuousBatcher", "CrossRequestHEBatcher", "HEProgramCache", "SecureCall",
           "SecureServing", "ServeConfig", "SessionPool", "SessionStats",
           "StepStats", "TenantSession", "build_secure_linears",
           "build_secure_serving", "serve_decode_step", "serve_prefill_step"]
