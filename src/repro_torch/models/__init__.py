from .gcn import gcn_init, gcn_apply, gcn_loss, make_graph_inputs
from .gat import (gat_dims, gat_init, gat_layer, gat_apply, gat_loss,
                  edge_softmax)
from .pna import (AGGREGATORS, SCALERS, pna_init, pna_aggregate, pna_apply,
                  pna_loss, mean_log_degree)
from .nequip import (N_PATHS, bessel_basis, poly_cutoff, nequip_init,
                     nequip_layer, nequip_apply, nequip_energy,
                     nequip_energy_forces)
from .sage_gin import (sage_init, sage_apply, sage_loss, sage_block_apply,
                       gin_init, gin_apply, gin_loss)
from .recsys import (WideDeepConfig, retrieval_score, user_tower,
                     widedeep_init, widedeep_logits, widedeep_loss)
from .transformer import (LMConfig, cast_params, lm_backbone,
                          lm_decode_step, lm_forward, lm_init, lm_loss,
                          lm_prefill, make_kv_caches)
