"""The render stream's join rule (pwnfps_tpu_torch/render/frame.py,
`join_key` and `must_join`) on CPU tensors.

On a CUDA device a frame runs on the device's render stream, which waits
on the caller's stream only where the frame's inputs may have been
written there since its last wait: a new world joins, the same world
unchanged does not, and the same world after an in-place write of any
of its tensors (which moves the tensor's version counter) joins again.
A frame on the CPU queues nothing on a render stream."""

import gc

import pytest
import torch

from pwnfps_tpu_torch.render import frame as frame_mod
from pwnfps_tpu_torch.render.frame import join_key, must_join, render_frame
from pwnfps_tpu_torch.scene import flagship_scene

TENSORS = frame_mod.WORLD_TENSORS


def _world():
    return flagship_scene(8, 8, "cpu").tworld


def test_every_world_tensor_is_keyed():
    """The key holds the version counter of each tensor of the world."""
    world = _world()
    names = [k for k, v in vars(world).items()
             if isinstance(v, torch.Tensor)]
    assert sorted(names) == sorted(TENSORS)
    assert join_key(world)[1] == tuple(getattr(world, k)._version
                                       for k in TENSORS)


def test_new_world_joins():
    """No join yet, another live world, or a world built after the joined
    one died (which may reuse its id) all join."""
    first = _world()
    assert must_join(first, None)
    key = join_key(first)
    assert must_join(_world(), key)
    del first
    gc.collect()
    assert must_join(_world(), key)


def test_same_world_unchanged_does_not_join():
    world = _world()
    key = join_key(world)
    for _ in range(3):
        assert not must_join(world, key)


@pytest.mark.parametrize("name", TENSORS)
def test_in_place_write_joins(name):
    """An in-place write of any of the world's tensors, through a view
    too, makes the next frame join; after the join the world is
    unchanged again."""
    world = _world()
    key = join_key(world)
    getattr(world, name).mul_(1)
    assert must_join(world, key)
    key = join_key(world)
    assert not must_join(world, key)
    getattr(world, name).view(-1)[:1].zero_()
    assert must_join(world, key)


def test_cpu_frame_queues_nothing_on_a_render_stream():
    sc = flagship_scene(8, 8, "cpu")
    before = (frame_mod.FRAMES_SIDE, frame_mod.STREAM_JOINS,
              dict(frame_mod._RENDER))
    render_frame(sc.tworld, sc.meta, sc.cfg, *sc.frame_args(0))
    assert (frame_mod.FRAMES_SIDE, frame_mod.STREAM_JOINS,
            frame_mod._RENDER) == before
