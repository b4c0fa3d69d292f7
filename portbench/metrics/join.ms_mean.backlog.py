"""Mean seconds of the window's joins in a backlog cell, in ms:
``join.ms_mean``'s reading, where the cell reports the output rate and
not the time to a first token."""
import pathlib

from portbench import spec

read = spec._load(pathlib.Path(__file__).with_name("join.ms_mean.py"),
                  "portbench_metric_join_ms_mean").read
