"""The learner: behavioural cloning (``bc``) and GAIL (``gail``)."""
