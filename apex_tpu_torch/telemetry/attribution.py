"""The pipeline attribution of ``apex_tpu/telemetry/attribution.py``
(straggler detection over ``pp_tick_<t>`` spans, bubble fraction): not
ported yet. It reads the spans the pipeline emits, so it comes with
pipeline parallelism, ROADMAP queue A item 6; it raises until then."""


class PipelineAttributor:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "telemetry.attribution.PipelineAttributor is not ported yet; "
            "it reads the pipeline's pp_tick spans and comes with "
            "pipeline parallelism, ROADMAP queue A item 6")
