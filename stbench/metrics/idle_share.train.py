"""The share of the traced span of a training batch in which no operation
ran on the device."""
from stbench import yardstick


def read(obs):
    return yardstick.idle_pct(obs.get("span"))
