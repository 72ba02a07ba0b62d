"""Training: the optimizer, the straggler watchdog, the batch seed, the
recsys and GNN minibatches and the loop."""
from .data import gnn_epoch_batches, minibatch_tensors, recsys_batches
from .fault import StepWatchdog, deterministic_batch_seed
from .loop import TrainResult, fit, make_train_step
from .optimizer import (Optimizer, adam, apply_updates, clip_by_global_norm,
                        global_norm, tree_leaves, tree_map)
