"""Access telemetry (``telemetry.py``): the count-min sketches and
top-k hot rows a train step carries, and their host-side summaries."""

from .telemetry import (TOPK_EMPTY, TelemetryConfig, config_from_env,
                        gather_state, hot_rows, init_telemetry, load_balance,
                        record_ids, resolve_config, restore_telemetry_state,
                        save_telemetry_state, summarize_telemetry,
                        table_loads_from_summary, telemetry_enabled,
                        zipf_alpha)

__all__ = ["TOPK_EMPTY", "TelemetryConfig", "config_from_env",
           "gather_state", "hot_rows",
           "init_telemetry", "load_balance", "record_ids", "resolve_config",
           "restore_telemetry_state", "save_telemetry_state",
           "summarize_telemetry", "table_loads_from_summary",
           "telemetry_enabled", "zipf_alpha"]
