"""The program's procedural field of boxes in the Cornell shell
(``build_tri_field(n_tris, seed)``)."""


def build(spec: dict, device):
    import spectral_tpu_torch as st

    return st.build_tri_field(int(spec["n_tris"]), int(spec["seed"]), device=device)
