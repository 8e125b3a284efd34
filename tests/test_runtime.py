"""Tests for the scan driver, Simulation wrapper, checkpointing, PNG writer, CLI."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from rust_particle_system.core.params import make_params
from rust_particle_system.models import Attractor, SPHFluid
from rust_particle_system.runtime import Simulation, checkpoint, run_frames
from rust_particle_system.runtime.cli import main as cli_main
from rust_particle_system.utils.png import write_png


def test_run_frames_equals_stepwise():
    model = Attractor.create(bounds=(-100.0, 100.0, -50.0, 50.0))
    params = model.default_params()
    s_scan = model.init(jax.random.key(0), 64)
    s_loop = model.init(jax.random.key(0), 64)
    s_scan = run_frames(model.step, s_scan, params, 10)
    step = jax.jit(model.step)
    for _ in range(10):
        s_loop = step(s_loop, params)
    np.testing.assert_allclose(
        np.asarray(s_scan.pos), np.asarray(s_loop.pos), rtol=1e-6, atol=1e-6
    )
    assert int(s_scan.frame) == 10


def test_simulation_wrapper_and_param_update():
    model = Attractor.create()
    sim = Simulation(model, n=32)
    sim.run(3)
    assert int(sim.state.frame) == 3
    sim.update_params(gravity=555.0)
    assert float(sim.params.gravity) == 555.0
    sim.run(2)
    assert int(sim.state.frame) == 5
    img = sim.render()
    assert img.shape == (1080, 1920, 4)


def test_sph_simulation_radius_update_recomputes_norms():
    model = SPHFluid.create(n=64, bounds=(-96.0, 96.0, -54.0, 54.0), capacity=16)
    sim = Simulation(model, n=64)
    old_norm = float(sim.params.density_kernel_norm)
    sim.update_params(smoothing_radius=6.0)
    assert float(sim.params.smoothing_radius) == 6.0
    assert float(sim.params.density_kernel_norm) != old_norm
    np.testing.assert_allclose(
        float(sim.params.density_kernel_norm), 10.0 / (np.pi * 6.0**5), rtol=1e-6
    )


def test_checkpoint_roundtrip(tmp_path):
    model = Attractor.create()
    params = model.default_params()
    state = model.init(jax.random.key(0), 128)
    state = jax.jit(model.step)(state, params)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, state, params)
    state2, params2 = checkpoint.load(path, state, params)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(state2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(params2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_continues_trajectory(tmp_path):
    """save -> load -> continue == uninterrupted run (bitwise)."""
    model = Attractor.create()
    params = model.default_params()
    s = model.init(jax.random.key(1), 64)
    step = jax.jit(model.step)
    for _ in range(4):
        s = step(s, params)
    path = str(tmp_path / "mid.npz")
    checkpoint.save(path, s)
    resumed = checkpoint.load(path, s)
    a, b = s, resumed
    for _ in range(4):
        a, b = step(a, params), step(b, params)
    np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))


def test_png_writer(tmp_path):
    img = np.zeros((4, 6, 4), np.uint8)
    img[..., 0] = 200
    img[..., 3] = 255
    path = str(tmp_path / "t.png")
    write_png(path, img)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IDAT" in data and b"IEND" in data


def test_cli_end_to_end(tmp_path):
    out_png = str(tmp_path / "frame.png")
    out_ckpt = str(tmp_path / "state.npz")
    rc = cli_main(
        [
            "--model", "attractor", "--n", "64", "--frames", "6", "--chunk", "3",
            "--render", out_png, "--save", out_ckpt, "--set", "gravity=100",
        ]
    )
    assert rc == 0
    assert os.path.exists(out_png) and os.path.getsize(out_png) > 100
    assert os.path.exists(out_ckpt)
    rc = cli_main(
        ["--model", "attractor", "--n", "64", "--frames", "2", "--resume", out_ckpt]
    )
    assert rc == 0


def test_simulation_stats_and_cli_stats(tmp_path, capsys):
    model = Attractor.create()
    sim = Simulation(model, n=32)
    sim.run(2)
    stats = sim.stats()
    assert stats["n"] == 32 and stats["frame"] == 2
    rc = cli_main(["--model", "attractor", "--n", "16", "--frames", "2", "--stats"])
    assert rc == 0
    assert "speed_mean" in capsys.readouterr().out


def test_checkpoint_shape_mismatch_raises(tmp_path):
    """Resuming with a different --n must fail loudly, not silently mis-shape."""
    import pytest

    model = Attractor.create()
    sim = Simulation(model, n=64)
    path = str(tmp_path / "c.npz")
    checkpoint.save(path, sim.state)
    other = Simulation(model, n=128)
    with pytest.raises(ValueError, match="expects"):
        checkpoint.load(path, other.state)


def test_cli_resume_restores_params(tmp_path, capsys):
    """--resume restores the checkpoint's physics params (VERDICT r1 #10)."""
    ck = str(tmp_path / "s.npz")
    cli_main(["--model", "attractor", "--n", "32", "--frames", "2",
              "--set", "attractor_strength=123.0", "--save", ck])
    capsys.readouterr()
    # fresh run resumes: must report restored params
    cli_main(["--model", "attractor", "--n", "32", "--frames", "1",
              "--resume", ck])
    out = capsys.readouterr().out
    assert "params restored" in out


def test_interactive_session_script(tmp_path):
    """The stdin-driven interactive loop (egui analog): set/run/render/save."""
    import io

    from rust_particle_system.runtime.interactive import Session

    buf = io.StringIO()
    s = Session(model_name="attractor", n=64, out=buf)
    png = str(tmp_path / "f.png")
    ck = str(tmp_path / "s.npz")
    for line in [
        "help",
        "run 3",
        "set attractor_strength=50",
        "params",
        "run 2",
        f"render {png}",
        f"save {ck}",
        "stats",
        "bogus_command",
    ]:
        assert s.dispatch(line) is True
    assert s.dispatch("quit") is False
    assert os.path.exists(png) and os.path.exists(ck)
    out = buf.getvalue()
    assert "attractor_strength = 50.0" in out
    assert "unknown command" in out
    assert int(s.sim.state.frame) == 5


def test_simulation_stats_reports_grid_overflow():
    """Grid-backed models surface occupancy + overflow in stats (ADVICE r1)."""
    model = SPHFluid.create(n=256, backend="grid")
    sim = Simulation(model, n=256)
    stats = sim.stats()
    assert "grid_overflow" in stats and "grid_max_occupancy" in stats
    assert stats["grid_overflow"] >= 0


def test_cli_profile_trace(tmp_path, capsys):
    """--profile captures a jax.profiler trace directory."""
    d = str(tmp_path / "trace")
    cli_main(["--model", "attractor", "--n", "32", "--frames", "2",
              "--profile", d])
    out = capsys.readouterr().out
    assert "profiler trace" in out
    assert os.path.isdir(d) and os.listdir(d)


def test_update_params_rejects_out_of_range_values():
    # The reference GUI clamps every tunable (src/parameter_gui.rs:38-70); the
    # slider analog must reject what the reference physically cannot produce.
    import pytest

    sim = Simulation(SPHFluid.create(n=32, bounds=(-96.0, 96.0, -54.0, 54.0),
                                     capacity=16), n=32)
    for bad in (dict(dt=-0.01), dict(dt=0.5), dict(gravity=-5.0),
                dict(damping_factor=2.0), dict(smoothing_radius=0.0),
                dict(pressure_multiplier=0.0), dict(viscosity_strength=-1.0)):
        with pytest.raises(ValueError):
            sim.update_params(**bad)
    # in-range updates still work
    sim.update_params(dt=0.005, gravity=100.0)
    np.testing.assert_allclose(float(sim.params.dt), 0.005, rtol=1e-6)


def test_trajectory_restores_original_order_for_resident_states():
    # Trajectory snapshots must track particle i at traj[:, i]: the run walk sorts
    # by cell every frame and must hand rows back in their original order.
    from rust_particle_system.runtime.simulation import run_frames_trajectory

    model = SPHFluid.create(n=96, bounds=(-96.0, 96.0, -54.0, 54.0),
                            backend="pallas", interpret=True)
    params = model.default_params()._replace(shader_delay=jnp.int32(0))
    state = model.init(jax.random.key(0), 96)

    sr, traj = run_frames_trajectory(model.step, state, params, 4)
    # oracle: step a copy frame by frame
    s = model.init(jax.random.key(0), 96)
    step = jax.jit(model.step)
    for f in range(4):
        s = step(s, params)
        np.testing.assert_allclose(np.asarray(traj[f]), np.asarray(s.pos),
                                   rtol=1e-6, atol=1e-6)


def test_pallas_render_falls_back_for_incompatible_geometry():
    # The pallas backend renders through the general splat for any geometry:
    # a stamp radius wider than the sprite and non-integral pixel strides alike.
    from rust_particle_system.render import RenderSpec, splat

    for rspec in (RenderSpec(width=192, height=108, max_radius_px=6),
                  RenderSpec(width=200, height=100, max_radius_px=2)):
        model = SPHFluid.create(n=48, bounds=(-96.0, 96.0, -54.0, 54.0),
                                backend="pallas", render_spec=rspec, interpret=True)
        params = model.default_params()
        state = model.init(jax.random.key(0), 48)
        img = model.render(state, params)
        assert img.shape == (rspec.height, rspec.width, 4)
        want = splat(state.pos, state.color, params.particle_size, params.bounds, rspec)
        np.testing.assert_array_equal(np.asarray(img), np.asarray(want))


def test_video_export_gif_and_webp(tmp_path):
    # The watching half of the reference's live loop (src/main.rs:73-80): frames
    # stitched into an animated clip.  GIF and WebP ride PIL; no ffmpeg needed.
    from PIL import Image

    from rust_particle_system.utils.video import VideoWriter, write_video

    frames = [
        np.full((32, 48, 4), v, np.uint8) for v in (0, 64, 128, 192)
    ]
    gif = tmp_path / "clip.gif"
    write_video(str(gif), frames, fps=10)
    with Image.open(gif) as im:
        assert im.n_frames == 4
        assert im.size == (48, 32)

    webp = tmp_path / "clip.webp"
    with VideoWriter(str(webp), fps=10) as vw:
        for f in frames:
            vw.add(f)
    with Image.open(webp) as im:
        assert im.size == (48, 32)

    import pytest

    with pytest.raises((RuntimeError, ValueError)):
        VideoWriter(str(tmp_path / "clip.xyz"))


def test_cli_video_flag(tmp_path):
    from PIL import Image

    out = tmp_path / "run.gif"
    rc = cli_main([
        "--model", "attractor", "--n", "64", "--frames", "6",
        "--video", str(out), "--video-every", "2",
    ])
    assert rc == 0
    with Image.open(out) as im:
        assert im.n_frames == 3


def test_interactive_video_command(tmp_path):
    import io

    from PIL import Image

    from rust_particle_system.runtime.interactive import Session

    out = io.StringIO()
    s = Session("attractor", n=32, out=out)
    clip = tmp_path / "s.gif"
    assert s.dispatch(f"video {clip} 4 2")
    with Image.open(clip) as im:
        assert im.n_frames == 2
    assert "video" in out.getvalue()


def test_ansi_frame_shape_and_colors():
    import numpy as np

    from rust_particle_system.utils.term import ansi_frame

    img = np.zeros((54, 96, 3), np.uint8)
    img[:27] = (255, 0, 0)   # top half red
    img[27:] = (0, 0, 255)   # bottom half blue
    s = ansi_frame(img, cols=32)
    lines = s.split("\n")
    # aspect preserved: rows = cols * h/w = 18 pixel rows -> 9 text lines
    assert len(lines) == 9
    assert "\x1b[38;2;255;0;0m" in lines[0]
    assert "\x1b[48;2;0;0;255m" in lines[-1]
    assert all(line.endswith("\x1b[0m") for line in lines)


def test_interactive_watch_command():
    import io

    from rust_particle_system.runtime.interactive import Session

    out = io.StringIO()
    s = Session("attractor", n=32, out=out)
    assert s.dispatch("watch 4 2 32")
    text = out.getvalue()
    assert "▀" in text          # half-block frames were drawn
    assert "watched 4 frames" in text


def test_walk_model_simulation_stats_without_capacity():
    """The walk model's grid has no slot table: stats report true occupancy and
    zero overflow however crowded a cell gets."""
    model = SPHFluid.create(n=200, bounds=(-96.0, 96.0, -54.0, 54.0),
                            backend="pallas", interpret=True)
    sim = Simulation(model, n=200)
    sim.state = sim.state._replace(pos=sim.state.pos.at[:80].set(1.0))
    sim.update_params(shader_delay=0)
    sim.run(2)
    stats = sim.stats()
    assert model.grid.capacity == 0
    assert stats["grid_overflow"] == 0
    assert stats["grid_max_occupancy"] >= 2
    assert stats["frame"] == 2


def test_cli_pallas_backend_refuses_cpu():
    import pytest

    with pytest.raises(RuntimeError, match="interpret=True"):
        cli_main(["--model", "sph", "--backend", "pallas", "--n", "32", "--frames", "1"])


def test_time_chained_chains_and_returns_state():
    from rust_particle_system.runtime.timing import time_chained, time_fn

    step = jax.jit(lambda x: x + 1.0)
    per, out = time_chained(step, jnp.zeros(3), 5)
    assert per > 0.0
    np.testing.assert_array_equal(np.asarray(out), np.full(3, 5.0))
    assert time_fn(step, jnp.zeros(3), reps=3, warm=1) > 0.0
