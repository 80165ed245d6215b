"""Multi-tenant secure serving — counterpart of ``repro/serve/``'s secure
tier: ``SessionPool`` / ``HEProgramCache`` (``sessions.py``),
``CrossRequestHEBatcher`` (``he_batcher.py``) and ``build_secure_serving``
(``engine.py``).  The LM serving loop comes with ROADMAP queue 1 item 10."""
from repro_torch.serve.engine import (SecureServing, ServeConfig,
                                      build_secure_linears,
                                      build_secure_serving)
from repro_torch.serve.he_batcher import (CrossRequestHEBatcher, SecureCall,
                                          StepStats)
from repro_torch.serve.sessions import (HEProgramCache, SessionPool,
                                        SessionStats, TenantSession)

__all__ = ["CrossRequestHEBatcher", "HEProgramCache", "SecureCall",
           "SecureServing", "ServeConfig", "SessionPool", "SessionStats",
           "StepStats", "TenantSession", "build_secure_linears",
           "build_secure_serving"]
