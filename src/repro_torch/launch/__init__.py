"""Entry points of the port's LM workload (``serve``)."""
