from .trace import StageTimer, stage_report, set_log_fn
