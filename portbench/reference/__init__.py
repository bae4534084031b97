"""The plain reference that decides a run's `correct`: frozen copies of the
port's plain PyTorch physics, collision, geometry, render, frame stack and
task resets and scores (each module says which file it copies), and
:mod:`env`, the reset, step, frames, observation and score of a scene
over them.  Nothing here imports the port."""
