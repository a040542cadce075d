"""TRC103 fire fixture: printing / formatting tensors on the hot path."""


# replint-torch: traced -- fixture: a hot-path entry point
def hot(x):
    print(x)                   # copies the values to the host
    msg = f"value={x}"         # so does the f-string
    return x, msg
