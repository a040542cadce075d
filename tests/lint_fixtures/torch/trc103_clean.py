"""TRC103 clean twin: formatting metadata only, and host code prints."""


# replint-torch: traced -- fixture: a hot-path entry point
def hot(x, label: str = "x"):
    note = f"tensor {label} shape {tuple(x.shape)} on {x.device}"
    return x, note


def host(x):
    print(x)                   # host code prints freely
    return x
