"""The plain reference that decides `correct`: the architectures, SMPL and
the body mask in plain PyTorch, float32, with no kernel, cache or batching
of the program under test.  It imports nothing of the program (a test
holds it to that) and takes the weights and assets that the benchmark
makes from the seed.
"""
