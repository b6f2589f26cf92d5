"""The share of the traced span of predict requests in which no operation
ran on the device."""
from stbench import yardstick


def read(obs):
    return yardstick.idle_pct(obs.get("span"))
