"""Plain PyTorch references of the configurations: ``dgp`` for the deep
GPs. They import nothing of the port and take only what the benchmark made
(data, parameter values, unit normals)."""
