"""Plan-fingerprinted result caching (the JAX package's `cache/`).

The machinery is the JAX package's, whole: fingerprint -> materialized
artifact, bounded by bytes, invalidated by version.  In the port it
backs the **result cache** (`exec/context.py`): a repeated identical SQL
query on one context returns its materialized host batches without
touching a source or the device.  Its second user is the worker
fragment cache (parallel/worker.py), keyed by `fragment_fingerprint`.

Knobs (read per store construction, overridable in-process for tests):

    DATAFUSION_TPU_CACHE         1 (default) / 0 — master switch
    DATAFUSION_TPU_CACHE_BYTES   byte budget per store (default 64 MiB)
    DATAFUSION_TPU_CACHE_TTL_S   per-entry TTL seconds (default 300;
                                 0 = entries never age out)

When off, nothing allocates: contexts hold `None` instead
of a store, and the hot paths pay one attribute-is-None test.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

from datafusion_tpu_torch.cache.fingerprint import (  # noqa: F401 — subsystem API
    canonical_json,
    digest,
    fragment_fingerprint,
    plan_fingerprint,
)
from datafusion_tpu_torch.cache.store import CacheStore  # noqa: F401

DEFAULT_MAX_BYTES = 64 << 20
DEFAULT_TTL_S = 300.0
_FALSY = ("0", "false", "off", "no")

# (enabled, max_bytes, ttl_s) test override; None = follow the env
_OVERRIDE: Optional[tuple] = None


def _env_config() -> tuple[bool, int, Optional[float]]:
    enabled = os.environ.get("DATAFUSION_TPU_CACHE", "1").lower() not in _FALSY
    max_bytes = int(
        os.environ.get("DATAFUSION_TPU_CACHE_BYTES", "") or DEFAULT_MAX_BYTES
    )
    ttl_env = os.environ.get("DATAFUSION_TPU_CACHE_TTL_S", "")
    ttl_s: Optional[float] = float(ttl_env) if ttl_env else DEFAULT_TTL_S
    if not ttl_s:
        ttl_s = None
    return enabled, max_bytes, ttl_s


def config() -> tuple[bool, int, Optional[float]]:
    """(enabled, max_bytes, ttl_s) — the active configuration."""
    return _OVERRIDE if _OVERRIDE is not None else _env_config()


def configure(enabled: Optional[bool] = None, max_bytes: Optional[int] = None,
              ttl_s: Optional[float] = None) -> None:
    """Override the env configuration in-process (tests).  Unspecified
    fields keep their env-derived values."""
    global _OVERRIDE
    env_enabled, env_bytes, env_ttl = _env_config()
    _OVERRIDE = (
        env_enabled if enabled is None else enabled,
        env_bytes if max_bytes is None else int(max_bytes),
        env_ttl if ttl_s is None else (ttl_s or None),
    )


def reset_config() -> None:
    """Drop a `configure` override: the environment decides again."""
    global _OVERRIDE
    _OVERRIDE = None


@contextmanager
def configured(enabled: Optional[bool] = None,
               max_bytes: Optional[int] = None,
               ttl_s: Optional[float] = None):
    """`with cache.configured(max_bytes=1024):` — scoped override."""
    global _OVERRIDE
    prev = _OVERRIDE
    configure(enabled, max_bytes, ttl_s)
    try:
        yield
    finally:
        _OVERRIDE = prev


def make_store(name: str) -> Optional[CacheStore]:
    """A fresh store under the active config, or None when caching is
    off (callers hold the None and skip all cache work)."""
    enabled, max_bytes, ttl_s = config()
    if not enabled:
        return None
    return CacheStore(max_bytes, ttl_s, name=name)
