from . import benchmarking, checkpoint, derivative_check, logging, timer, tree
