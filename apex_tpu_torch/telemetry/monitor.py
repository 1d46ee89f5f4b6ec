"""The live control plane of ``apex_tpu/telemetry/monitor.py`` (rolling
windows, alert rules, OpenMetrics exposition): not ported yet. In the
JAX package only the serving fleet feeds it, so it comes with the fleet,
ROADMAP queue A item 5(c); each name raises until then."""


def _not_ported(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"telemetry.monitor.{name} (the live monitor) is not ported "
            f"yet; it comes with the serving fleet, ROADMAP queue A item "
            f"5(c)")

    refuse.__name__ = name
    return refuse


Monitor = _not_ported("Monitor")
AlertRule = _not_ported("AlertRule")
JsonlTailer = _not_ported("JsonlTailer")
default_rules = _not_ported("default_rules")
parse_openmetrics = _not_ported("parse_openmetrics")
render_openmetrics = _not_ported("render_openmetrics")
