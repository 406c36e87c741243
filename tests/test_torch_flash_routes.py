"""Kernel 11's route rule (kernel.route / check_route), on the CPU: which
of csrc/flash_attention.cu's two kernels a dtype and head dim take, that
the serving configs' bf16 shapes take the tensor cores, and that the
wrapper refuses a route a call cannot take before it touches the device.
The kernels themselves are held against the plain version on the card by
chip_smoke.py, on both routes."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as K


@pytest.mark.parametrize("d", K.HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "cuda_core")])
def test_route_choice(dtype, d, want):
    assert K.route(dtype, d) == want


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "internlm2-1.8b",
                                  "mixtral-8x22b", "moonshot-v1-16b-a3b"])
def test_the_serve_configs_shapes_take_the_tensor_core_route(arch):
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16"
    assert cfg.resolved_head_dim in K.HEAD_DIMS
    assert K.route(torch.bfloat16, cfg.resolved_head_dim) == "wgmma"


def test_recurrentgemma_is_the_head_dim_256_path():
    assert get_config("recurrentgemma-2b").resolved_head_dim == 256


def q_of(dtype, d, shape=(1, 1, 2, 8)):
    return torch.zeros((*shape, d), dtype=dtype)


@pytest.mark.parametrize("dtype,d,way,want", [
    (torch.bfloat16, 256, None, "wgmma"),
    (torch.bfloat16, 256, "wgmma", "wgmma"),
    (torch.bfloat16, 256, "cuda_core", "cuda_core"),   # for measurement
    (torch.bfloat16, 32, "cuda_core", "cuda_core"),
    (torch.float32, 256, None, "cuda_core"),
    (torch.float32, 64, "cuda_core", "cuda_core"),
])
def test_check_route_takes_the_route_or_the_cuda_cores(dtype, d, way, want):
    assert K.check_route(q_of(dtype, d), way) == want


@pytest.mark.parametrize("dtype,d,way,match", [
    (torch.float32, 256, "wgmma", "route 'wgmma'"),    # fp32: CUDA cores
    (torch.float32, 128, "wgmma", "route 'wgmma'"),
    (torch.bfloat16, 256, "tf32", "route 'tf32'"),     # no such route
    (torch.bfloat16, 96, None, "head dim 96"),         # not instantiated
    (torch.bfloat16, 512, "cuda_core", "head dim 512"),
])
def test_wrapper_refuses_a_route_the_call_cannot_take(dtype, d, way, match):
    """On CPU tensors the refusal comes before the device check (which
    would say "needs a CUDA tensor"), and nothing launches."""
    before = K.LAUNCHES
    q = q_of(dtype, d)
    k = torch.zeros((1, 1, 8, d), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        K.flash_attention_fwd(q, k, k.clone(), way=way)
    assert K.LAUNCHES == before


def test_wrapper_refuses_q_of_another_rank_before_the_device_check():
    with pytest.raises(ValueError, match=r"\(B, KVH, G, Sq, D\)"):
        K.flash_attention_fwd(torch.zeros((2, 8, 64)),
                              torch.zeros((1, 2, 8, 64)),
                              torch.zeros((1, 2, 8, 64)))


def test_a_taken_route_reaches_the_device_check():
    """A route the call can take passes the route check; on CPU tensors
    the wrapper then refuses the device, without launching."""
    before = K.LAUNCHES
    q = q_of(torch.bfloat16, 256)
    k = torch.zeros((1, 1, 8, 256), dtype=torch.bfloat16)
    for way in (None, "wgmma", "cuda_core"):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            K.flash_attention_fwd(q, k, k.clone(), way=way)
    assert K.LAUNCHES == before


def test_route_codes_are_the_launch_entry_points():
    """csrc/flash_attention.cu takes route 0 for flash_fwd_kernel and 1
    for flash_wgmma_kernel."""
    assert K.ROUTES.index("cuda_core") == 0
    assert K.ROUTES.index("wgmma") == 1
