"""Median host milliseconds a frame inside ``RenderPipeline.render`` but in
none of its children's spans: the ``pipeline.render`` span of the port's
tracer less the spans it opens (the renderer's choice, the caches, the
glue between the layers)."""

from benchmark import program_trace


def read(run):
    w = program_trace.window(run)
    if w is None or run.unit != "frames" or not run.port_kernels:
        return None
    return w.median_ms(lambda k: w.self_ns(k)
                       if w.spans[k].name == "pipeline.render" else 0)
