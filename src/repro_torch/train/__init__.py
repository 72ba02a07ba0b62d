"""Training: the optimizers, checkpoints, fault tolerance, data pipelines
and the loop (the port of ``repro.train``; ``elastic_mesh`` waits for the
distributed slice, ROADMAP §1 item 9)."""
from .checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                         save_checkpoint)
from .data import (Prefetcher, gnn_epoch_batches, lm_token_batches,
                   minibatch_tensors, recsys_batches)
from .fault import (RetryingStep, StepWatchdog, deterministic_batch_seed,
                    resume)
from .loop import TrainResult, fit, make_train_step
from .optimizer import (OPTIMIZERS, Optimizer, adam, apply_updates,
                        clip_by_global_norm, cosine_warmup_schedule,
                        global_norm, lamb, sgd, tree_leaves, tree_map)
