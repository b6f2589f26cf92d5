"""The tracer's clock against torch.profiler's on the card: a program span
(`st_dadk_tpu_torch/utils/trace.py`) around one kernel launch holds that
launch's runtime call in the profiler's Chrome trace, each mapped through
the trace's `baseTimeNanoseconds` (`trace_steady_state.clock_slack_us`, the
check its capture records). Needs a CUDA device and skips without one
(decided inside the test); on the card:

    python3 -m pytest --noconftest -p no:cacheprovider -m chip \\
        tests/test_torch_trace_clock.py
"""
import pytest
import torch

from st_dadk_tpu_torch import trace_steady_state as tts
from st_dadk_tpu_torch.utils import trace

SLACK_US = 50.0


@pytest.mark.chip
def test_a_span_holds_its_launch_on_the_trace_clock(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trace.disable()
    trace.drain()
    slack = tts.clock_slack_us(tmp_path)
    assert slack <= SLACK_US, f"the launch lies {slack:.1f} us outside"
