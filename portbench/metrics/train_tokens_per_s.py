"""Tokens trained a second: clients x batch x sequence x the window's
local steps, over the window's seconds.  Aggregation steps train no
token; their time is the communication users pay for."""


def read(run):
    cfg = run.config
    tokens = cfg["clients"] * cfg["batch_per_client"] * cfg["seq_len"]
    return tokens * run.steps_of(0) / run.window_s
