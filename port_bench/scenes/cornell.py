"""The program's Cornell box of scene 0 (``spectral_tpu_torch.CORNELL``)."""


def build(spec: dict, device):
    import spectral_tpu_torch as st

    return st.build_scene(st.CORNELL, device=device)
