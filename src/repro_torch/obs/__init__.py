"""End-to-end episode observability (a copy of ``repro.obs``): a span
tracer, Perfetto export and critical-path latency attribution.

``Tracer`` records per-episode lifecycle marks and per-track spans from
every disaggregated stage; ``export_chrome`` renders Perfetto-loadable
JSON; ``repro_torch.obs.report`` decomposes each episode's
submission→commit latency into additive per-stage components and names
each tenant's bottleneck stage."""
from .tracer import COMPONENT_OF, TERMINAL_STATES, Tracer

__all__ = ["Tracer", "COMPONENT_OF", "TERMINAL_STATES"]
