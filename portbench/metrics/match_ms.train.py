"""Device ms a step of the ops launched inside the program's
``train.match`` label: the auction of the set losses, its CUDA-graph
replays (whose kernels carry their ``cudaGraphLaunch``'s correlation) and
its convergence tests."""

from harness import stages


def read(ctx):
    return stages.busy_ms(ctx, ('train.match',), per='steps')
