"""Training: the optimizer, the straggler watchdog, the batch seed, the
recsys batches and the loop."""
from .data import recsys_batches
from .fault import StepWatchdog, deterministic_batch_seed
from .loop import TrainResult, fit, make_train_step
from .optimizer import (Optimizer, adam, apply_updates, clip_by_global_norm,
                        global_norm, tree_leaves, tree_map)
