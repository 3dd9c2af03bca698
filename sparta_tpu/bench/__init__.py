from .runner import run_experiment, save_csv
from .timing import time_op

__all__ = ["run_experiment", "save_csv", "time_op"]
