"""Paper-native convex problem: l2-regularized logistic regression on an
a1a-like dataset (d=124), 5 clients — the paper's §VII-A meta-parameter
study setting; the counterpart of ``repro.configs.logreg_a1a``.  Not an
ArchConfig; exported constants used by examples and benchmarks."""
D_FEATURES = 124
N_CLIENTS = 5
L2 = 0.01
