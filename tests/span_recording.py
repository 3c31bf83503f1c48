"""The `spans` fixture of the port's span tests: `utils.profiling`'s host
recording on for one test, off and emptied after it. Test modules import
it (``from span_recording import spans``)."""

import pytest

from facenet_tpu_torch.utils import profiling


@pytest.fixture
def spans():
    """Host recording on for one test, off and emptied after; yields
    `utils.profiling`."""
    profiling.span_summary(reset=True)
    profiling.record_spans(True)
    try:
        yield profiling
    finally:
        profiling.record_spans(False)
        profiling.span_summary(reset=True)
