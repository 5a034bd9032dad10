"""Set-up: imports, the kernels' build or load, the weights, the runtime,
and the pipeline's warm-up until every tenant has committed once."""


def read(st):
    return st.setup["setup_s"]
