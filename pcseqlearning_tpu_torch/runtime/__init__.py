"""Training and evaluation runtime (counterpart of pcseqlearning_tpu.runtime):
optimizers and schedules, the train loop with checkpoints, and the
detection metrics."""
