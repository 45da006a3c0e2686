"""Runtime analysis (counterpart of ``deepspeed_tpu/analysis``); the slice holds the serving sanitizer checks."""
