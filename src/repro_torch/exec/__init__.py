"""Forward execution plans (aggregation and whole layers) over the block-ELL
kernel, its plain version, or a dst-sorted edge list."""
from .plan import (BACKENDS, MODES, ORDERS, GraphExecutionPlan,
                   LayerExecutionPlan, build_layer_plan, build_plan,
                   choose_order, layer_order_costs, spmm_cost)
