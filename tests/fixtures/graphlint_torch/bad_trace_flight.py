"""JG107: structured-log / flight-recorder calls inside a CUDA-graph capture.
Each call below fires at CAPTURE time — one flight event (or log record)
per capture instead of per replay, stamped with capture-time values.
Translates tests/fixtures/graphlint/bad_trace_flight.py."""

import torch

from janusgraph_tpu_torch.observability import flight_recorder, get_logger

logger = get_logger("olap")


def superstep(state):
    flight_recorder.record("olap_resume", step=0)  # expect: JG107
    logger.info("superstep-start", step=0)  # expect: JG107
    return state * 2.0


def body(state):
    out = state + 1.0
    flight_recorder.dump(reason="mid-superstep")  # expect: JG107
    logger.error("superstep-failed")  # expect: JG107
    return out


def capture(state: torch.Tensor):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = body(superstep(state))
    logger.info("captured")  # host code after the capture: must NOT fire
    return g, out
