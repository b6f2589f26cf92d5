"""The fused forward's share of its roofline in the traced span of a
training batch."""
from stbench import yardstick


def read(obs):
    return yardstick.fused_roofline_pct(obs.get("span"), "fwd")
