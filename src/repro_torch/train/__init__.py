"""Training: the optimizer, the straggler watchdog and the loop."""
from .fault import StepWatchdog
from .loop import TrainResult, fit, make_train_step
from .optimizer import (Optimizer, adam, apply_updates, clip_by_global_norm,
                        global_norm, tree_leaves, tree_map)
