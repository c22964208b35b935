"""Training several seeds of one model together (counterpart of
multistgraph_tpu/parallel; the port keeps its multi-seed module)."""
