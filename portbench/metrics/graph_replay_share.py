"""100 x the share of the level predictors' calls (``batching.predict``)
that replayed a CUDA graph (a ``pipeline.replay`` span among their
children): how far the pipeline's graphs are engaged in the traced phase.
None where the program records no ``pipeline.*`` span at all, as a program
without graphs does."""
from portbench import program_spans


def read(summary):
    spans = program_spans.load(summary)
    if spans is None or not any(s["name"].startswith("pipeline.") for s in spans):
        return None
    predicts = program_spans.named(spans, "batching.predict")
    if not predicts:
        return None
    replayed = {s["parent"] for s in program_spans.named(spans, "pipeline.replay")}
    return 100.0 * sum(p["id"] in replayed for p in predicts) / len(predicts)
