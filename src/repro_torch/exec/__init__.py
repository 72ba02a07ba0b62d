"""Execution plans (aggregation and whole layers, with their backwards)
over the block-ELL kernels, their plain versions, or a dst-sorted edge
list."""
from .plan import (BACKENDS, MODES, ORDERS, GraphExecutionPlan,
                   LayerExecutionPlan, build_layer_plan, build_plan,
                   choose_order, layer_order_costs, spmm_cost)
