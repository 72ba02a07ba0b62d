from .gcn import gcn_init, gcn_apply, gcn_loss, make_graph_inputs
from .sage_gin import (sage_init, sage_apply, sage_loss, sage_block_apply,
                       gin_init, gin_apply, gin_loss)
from .recsys import (WideDeepConfig, retrieval_score, user_tower,
                     widedeep_init, widedeep_logits, widedeep_loss)
from .transformer import (LMConfig, cast_params, lm_backbone,
                          lm_decode_step, lm_forward, lm_init, lm_prefill,
                          make_kv_caches)
