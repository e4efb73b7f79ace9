"""Request patterns of the paper's benchmarks, as write-executor inputs."""
