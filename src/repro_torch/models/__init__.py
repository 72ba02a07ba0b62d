from .gcn import gcn_init, gcn_apply, make_graph_inputs
